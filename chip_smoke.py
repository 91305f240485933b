#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``dlrover_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper
card::

    python3 chip_smoke.py            # everything, as the chip check runs it
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --layers 4 # main path at reduced depth
    python3 chip_smoke.py --profile  # + torch.profiler decode/train steps
    python3 chip_smoke.py --skip-serve --train-layers 2 --int8-layers 4
    python3 chip_smoke.py --serve-only  # the serving legs alone
    python3 chip_smoke.py --ckpt-only   # build + the checkpoint leg
    python3 chip_smoke.py --skip-ckpt --ckpt-layers 2

Phases (any failed check raises, so the script exits nonzero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 and
   reduced-precision bf16 reductions are switched off for every matmul
   (the training leg goes back to PyTorch's default for the latter).
2. build: the kernels of both paths from ``ops/csrc`` (one ``nvcc`` per
   source, in parallel), with the build seconds and the ``ptxas``
   register report.
3. kernels against their plain PyTorch versions on the card, bf16 and
   fp32, at full width (RMSNorm, its residual entry and its backward
   from 1 to 8192 rows, D = 100 to 40,000, x off a 16-byte boundary,
   bf16 x with an fp32 weight; each check also shown to reject a planted
   fault: the forward with each row's last vector dropped from its sum
   of squares, the residual entry squaring the unrounded fp32 x + delta,
   the backward with one CTA's dw sum dropped and with each row's last
   vector dropped from its dot product (in bf16 read by the share of dx
   differing), whose three runs must be equal bit for bit; paged decode and verify at head_dim 16, 32, 64, 128 and 256,
   GQA group 1/4/8, block_size 16, ragged lengths including 0 and a full
   table, verify horizons on the last and the first key of a split and
   at position 0, inactive lanes on the null block, 1e4 and NaN poison
   in the null block and the guard blocks, verify window C=4 (up to 32
   rows), each check also shown to reject the plain version with each
   lane's last split dropped, and the
   verify kernel at the serving shape, three runs bit for bit and timed;
   the T > 0 sampler's threefry bits on the card against the CPU's;
   flash forward, dK/dV and dQ over S 1-2048, D 16/32/64/128, groups 1/4/8,
   causal or not, NaN past every input, each check also shown to reject
   a kernel that drops one tile, and the three kernels at the training
   shape, three runs bit for bit and timed against SDPA, with their
   ``ptxas`` registers, spills and shared memory); blockwise int8
   quantize, dequantize and the fused
   Adam update over ragged sizes, an all-zero block, a one-spike block
   and the half-way block, bit for bit, each check also shown to reject
   a plain version with one block left stale, and ``QuantizedMoments``
   on the card against its steps written with the plain version; then
   ``LlamaConfig.tiny()`` at its own widths (head_dim 16) in fp32 served
   on the card and on the CPU from the same params, whose tails (greedy
   and at T=0.8) and K=3 acceptance counts must agree (K=1 and K=3, with
   preemption), and trained for 3 steps on both, with AGD and with
   ``QuantizedMoments`` in fp32 and with AGD in bf16, whose losses, grad
   norms and params must agree.
4. serving main path: Llama-2-7B at full width and depth (bf16, random weights
   from a seeded generator on the card) served by the continuous-batching
   scheduler over the paged pool: 16 requests with 128-1024-token prompts
   and 64 new tokens each, once with K=1 and once with
   ``DLROVER_TPU_DECODE_STEPS=4``.  Launch counters are zeroed just
   before each leg and read just after; every kernel must have launched.
   The greedy tails of the two legs must be identical, and the K=4 leg
   must accept at least ``ACCEPT_FLOOR`` drafts per window.  Each leg
   prints its decode-step time on the card's clock and the device time
   of its step's forwards (CUDA-graph replays of the captured full-batch
   step).  One layer's inputs of one decode step and one verify step are
   captured (the attention norm, the MLP norm with the residual add
   fused in, paged decode, paged verify), and each kernel is held against
   its plain version on them (and must not match the planted fault;
   three runs bit for bit) and timed there.
5. training main path: Llama-2-7B width at ``--train-layers`` layers
   (default 8), fp32 masters, bf16 compute, through ``auto_accelerate``
   -> ``Trainer.train`` with AGD for ``--train-steps`` steps of 4 x 2048
   tokens.  Step 0's attention grads are held against dense attention,
   the loss must fall, launches per step must be as stated; step and
   optimizer times are on the card's clock.  Layer 0's RMSNorm (both
   entries) and flash inputs and a fused norm's backward are captured,
   checked (flash and the backward three runs bit for bit) and timed
   against their plain versions, ``F.rms_norm`` and SDPA.
5b. int8 leg: Llama-2-7B at ``--int8-layers`` layers (default 32, full
   depth) trained the same way with ``QuantizedMoments(lr=3e-4,
   weight_decay=0.1)``: launches per step (B9 once per leaf) and at init
   (B7 twice per leaf), the loss falling, peak memory; the trained
   moments dequantized (B8) and their norms printed; the last step's
   largest leaf captured, B7-B9 checked and timed on it.
6. flash-checkpoint leg: the ``df`` of ``/dev/shm`` and of the
   checkpoint dir (under ``build/``, made fresh and removed at the end),
   free RAM, and the pinned 1 GiB copy rate each way (the yardstick).
   Then at Llama-2-7B widths, with the depth the largest of 8, 4, 2
   whose two shm slots fit in half of the free ``/dev/shm`` (bounded by
   free RAM, which tmpfs pages take; ``--ckpt-layers`` sets it), for AGD
   (``snapshot_mode="auto"``, "copy" here) and ``QuantizedMoments``
   ("staged"), 4 x 2048 tokens a step: run A trains 4 steps; run B 2 with
   a snapshot every step and a persist at step 2, whose losses and grad
   norms must equal A's; run C, a fresh ``Trainer``, restores from shm
   (an in-process saver plays the agent, so the segments outlive each
   ``Trainer``) and trains to step 4; run D, the segments unlinked,
   restores from the ``.drckpt`` and trains to step 4.  C's and D's
   losses, grad norms and every state leaf must equal A's bit for bit,
   and the restored runs must launch the path's kernels (counts zeroed
   before each).  Two planted faults (AGD): one leaf's last byte flipped
   in the shm slot must be seen by the leaf comparison, and a restore
   that leaves the optimizer's step count at 0 by the loss comparison.
   Printed with the card's name and power limit: the host time of each
   ``_maybe_checkpoint`` call, each drain's and restore's GB/s, each
   run's step times, the preallocation and persist GB/s, and a
   ``dd``-style write of the AGD state's bytes to the same disk.  Every
   segment is unlinked and every file removed in a ``finally``.
7. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

It exits nonzero without printing a result when CUDA is unavailable or
when the package is not beside it.
"""

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

# the int8 leg holds ~63 GiB of state and needs 5.4 GiB in one piece in
# its backward: without expandable segments the caching allocator's
# cached blocks fragment (11.5 GiB reserved but unusable at the OOM of a
# full-depth run), as PyTorch's out-of-memory message itself suggests
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
POISON = 1e4
# K=4 acceptance at 7B, random weights: 3.36-3.39 tokens per window
# measured, at most 3.94 with 63 decoded tokens per request
ACCEPT_FLOOR = 2.5
SEED = 0  # weights and prompts


def log(*parts):
    print(*parts, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls are captured in
    a CUDA graph, and the median of ``iters`` CUDA-event-timed replays
    is divided by ``reps``.  The graph takes the host's launch cost out,
    so kernel, plain version and library call are timed alike."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| where both are finite; a NaN in one but not the
    other counts as infinite error."""
    a, b = a.float(), b.float()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    d = (a - b).abs().masked_fill(nan_a, 0.0)
    return float(d.max()) if d.numel() else 0.0


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------- kernels


RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.0625}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


def differing(a, b) -> int:
    return int((a != b).sum())


def dropped_vector_ref(x, w, eps):
    """The planted fault of the forward: the plain version with each
    row's last 16-byte vector left out of its sum of squares, as when a
    kernel's loop stops one vector short."""
    xf = x.float()
    d = x.shape[-1]
    keep = xf[..., :max(d - 16 // x.element_size(), 0)]
    var = (keep * keep).sum(-1, keepdim=True) / d
    rstd = 1.0 / torch.sqrt(var + eps)
    return (xf * rstd * w.float()).to(x.dtype), rstd


def rms_readings(y, rstd, y_ref, rstd_ref):
    """(max |y - ref|, max |rstd - ref| / max |ref|, share of y differing)"""
    return (max_err(y, y_ref),
            max_err(rstd, rstd_ref) / float(rstd_ref.abs().max()),
            differing(y, y_ref) / max(y.numel(), 1))


def norm_input(n, d, dtype, gen, offset=0):
    """``[n, d]`` of ``dtype``, starting ``offset`` elements into its
    allocation (1: not 16-byte aligned, the scalar path)."""
    buf = torch.randn(n * d + offset, device="cuda", generator=gen).to(dtype)
    return buf[offset:].view(n, d)


def check_rms(fused, dtype, n, d, gen, offset=0) -> float:
    """The forward against its plain version: y within RMS_TOL (fp32:
    summation order only; bf16: one rounding of |y| < 16 may land one
    ulp, <= 2^-4, apart), rstd within 1e-5 relative, and in bf16 at most
    1e-3 of the outputs differing; the plain version with each row's last
    vector dropped from its sum of squares (``dropped_vector_ref``) must
    be out of the rstd limit."""
    x = norm_input(n, d, dtype, gen, offset)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    y, rstd = fused.rms_norm_fwd(x, w, 1e-5)
    torch.cuda.synchronize()
    err, rerr, mis = rms_readings(y, rstd, *fused.rms_norm_plain(x, w, 1e-5))
    _, rerr_bad, mis_bad = rms_readings(y, rstd,
                                        *dropped_vector_ref(x, w, 1e-5))
    ok = (err <= RMS_TOL[dtype] and rerr <= 1e-5 < rerr_bad
          and (dtype != torch.bfloat16 or mis <= 1e-3))
    log(f"[check] rms_norm {str(dtype)[6:]} N={n} D={d} offset={offset} "
        f"max_abs_err={err:.3g} rstd_rel_err={rerr:.3g} differing={mis:.2e}"
        f"; last vector dropped: rstd_rel_err={rerr_bad:.3g} differing="
        f"{mis_bad:.2e} (need rstd <= 1e-5 < it, y <= {RMS_TOL[dtype]}, "
        f"bf16 differing <= 1e-3) {'ok' if ok else 'FAIL'}")
    require(ok, f"rms_norm {dtype} N={n} D={d} offset={offset}, or its "
            "check cannot see the planted fault")
    return err


def unrounded_ref(x, delta, w, eps):
    """The planted fault of the residual entry: ``x + delta`` kept in
    fp32 (never rounded to x's type) and normalised so."""
    hf = x.float() + delta.float()
    rstd = 1.0 / torch.sqrt(torch.mean(hf * hf, -1, keepdim=True) + eps)
    return (hf * rstd * w.float()).to(x.dtype), rstd


def check_add_rms(fused, dtype, n, d, gen, w_dtype=None, offset=0) -> float:
    """The residual entry against its plain version (``x + delta``, then
    the plain norm): h equal bit for bit, y and rstd as ``check_rms``; in
    bf16 at most 1e-3 of the outputs differing, and more than that against
    the plain version that squares the unrounded fp32 ``x + delta``."""
    x = norm_input(n, d, dtype, gen, offset)
    delta = norm_input(n, d, dtype, gen, offset)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(
        w_dtype or dtype)
    h, y, rstd = fused.add_rms_norm_fwd(x, delta, w, 1e-5)
    torch.cuda.synchronize()
    h_ref, y_ref, rstd_ref = fused.add_rms_norm_plain(x, delta, w, 1e-5)
    err, rerr, mis = rms_readings(y, rstd, y_ref, rstd_ref)
    _, _, mis_bad = rms_readings(y, rstd, *unrounded_ref(x, delta, w, 1e-5))
    same_h = torch.equal(h, h_ref)
    ok = (same_h and err <= RMS_TOL[dtype] and rerr <= 1e-5
          and (dtype != torch.bfloat16 or mis <= 1e-3 < mis_bad))
    log(f"[check] add_rms_norm {str(dtype)[6:]} x, {str(w.dtype)[6:]} "
        f"weight N={n} D={d} offset={offset} h equal: {same_h} max_abs_err="
        f"{err:.3g} rstd_rel_err={rerr:.3g} differing={mis:.2e}; unrounded "
        f"x + delta: differing={mis_bad:.2e} (bf16: need <= 1e-3 < it) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"add_rms_norm {dtype} N={n} D={d}, or its check cannot "
            "see the planted fault")
    return err


def dx_err(got, ref) -> float:
    """Worst row's max |got - ref| over its limit: one bf16 ulp of the
    row's largest |ref| (bf16: both round the same fp32 values, which
    differ only through the order of the row's dot product), or 1e-5 of
    it (fp32)."""
    d = got.shape[-1]
    g, r = got.float().reshape(-1, d), ref.float().reshape(-1, d)
    top = r.abs().amax(-1).clamp_min(1e-30)
    unit = (2.0 ** (torch.floor(torch.log2(top)) - 7)
            if got.dtype == torch.bfloat16 else 1e-5 * top)
    return float(((g - r).abs().amax(-1) / unit).max())


def dropped_dot_ref(x, w, rstd, g, g_res):
    """The planted fault of the backward's dx: the plain version with
    each row's last 16-byte vector left out of its dot product, as when a
    kernel's loop stops one vector short."""
    d = x.shape[-1]
    keep = max(d - 16 // x.element_size(), 0)
    xhat = x.float() * rstd
    dxhat = g.float() * w.float()
    dot = torch.sum((dxhat * xhat)[..., :keep], dim=-1, keepdim=True) / d
    dx = (rstd * (dxhat - xhat * dot)).to(x.dtype)
    return dx if g_res is None else dx + g_res


def dx_readings(dx, dx_ref, dx_bad):
    """(``dx_err`` against the plain version, share of dx differing from
    it, and both readings against the version with the dropped vector)"""
    n = max(dx.numel(), 1)
    return (dx_err(dx, dx_ref), differing(dx, dx_ref) / n,
            dx_err(dx, dx_bad), differing(dx, dx_bad) / n)


def dx_ok(dtype, e_dx, mis, e_bad, mis_bad) -> bool:
    """dx within its limit, and the dropped vector out of it: in fp32 by
    ``dx_err``, in bf16 (where one ulp of the row's largest |dx| hides
    the fault) by at most 1e-3 of dx differing against more than that."""
    if dtype == torch.bfloat16:
        return e_dx <= 1.0 and mis <= 1e-3 < mis_bad
    return e_dx <= 1.0 < e_bad


def dw_limit(dw_ref) -> float:
    """1e-4 of max |dw| (fp32 sums in another order), or one bf16 ulp of
    it when dw is bf16 (both round those sums once)."""
    top = float(dw_ref.float().abs().max())
    if dw_ref.dtype == torch.bfloat16:
        return max(1e-4 * top, 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7))
    return 1e-4 * top


def dropped_part_ref(fused, x, w, rstd, g):
    """The planted fault of the backward: ``dw`` without the rows of the
    last CTA (rows ``c, c + parts, ...``), as when one CTA's sum is lost."""
    d = x.shape[-1]
    parts = fused.bwd_parts(x.numel() // d, x.device)
    xhat = x.float().reshape(-1, d) * rstd.reshape(-1, 1)
    keep = (torch.arange(xhat.shape[0], device=x.device) % parts
            != parts - 1)
    return torch.sum((g.float().reshape(-1, d) * xhat)[keep], 0).to(w.dtype)


def check_rms_bwd(fused, dtype, w_dtype, n, d, res, gen):
    """The backward against its plain version on the plain forward's
    rstd: dx as ``dx_ok`` holds it against the plain version and the one
    with each row's last vector dropped from its dot product
    (``dropped_dot_ref``), dw within ``dw_limit``, and out of that with one
    CTA's sum dropped (``dropped_part_ref``); three runs equal bit for
    bit."""
    x = norm_input(n, d, dtype, gen)
    g = norm_input(n, d, dtype, gen)
    g_res = norm_input(n, d, dtype, gen) if res else None
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(w_dtype)
    rstd = fused.rms_norm_plain(x, w, 1e-5)[1]
    dx, dw = fused.rms_norm_bwd(x, w, rstd, g, g_res)
    torch.cuda.synchronize()
    dx_ref, dw_ref = fused.rms_norm_bwd_plain(x, w, rstd, g, g_res)
    lim = dw_limit(dw_ref)
    dxr = dx_readings(dx, dx_ref, dropped_dot_ref(x, w, rstd, g, g_res))
    e_dw = max_err(dw, dw_ref) / lim
    e_bad = max_err(dw, dropped_part_ref(fused, x, w, rstd, g)) / lim
    same = bitwise_repeat(lambda: fused.rms_norm_bwd(x, w, rstd, g, g_res))
    ok = dx_ok(dtype, *dxr) and e_dw <= 1.0 < e_bad and same
    log(f"[check] rms_norm_bwd {str(dtype)[6:]} x, {str(w_dtype)[6:]} "
        f"weight N={n} D={d} g_res={res} parts="
        f"{fused.bwd_parts(n, x.device)} dx err/limit={dxr[0]:.3g} "
        f"differing={dxr[1]:.2e}, last vector dropped from dot: err/limit="
        f"{dxr[2]:.3g} differing={dxr[3]:.2e} (fp32: need err/limit <= 1 "
        f"< it; bf16: differing <= 1e-3 < it); dw err/limit={e_dw:.3g}, "
        f"one CTA's sum dropped dw={e_bad:.3g} (dw limit {lim:.3g}); 3 "
        f"runs equal bit for bit: {same} {'ok' if ok else 'FAIL'}")
    require(ok, f"rms_norm_bwd {dtype} N={n} D={d} g_res={res}, or its "
            "check cannot see the planted fault")
    return dxr[0], e_dw


def attention_case(pk, group, dtype, poison, gen, kv=4, head_dim=128,
                   block_size=16, max_blocks=24, window=4):
    """Pools with normal K/V in lanes' blocks and poison in the null
    block and in the guard block every unused table entry points at;
    ragged lengths including 0 and a full table, lanes whose verify
    horizon (pos + C - 1) ends on the last key of a split and on the
    first key of the next, lanes at pos = 0, and an inactive lane (length
    1 on table row 0).  C * G reaches 32 rows at group 8."""
    pages, _, _ = pk.verify_plan(1, window * group, kv, max_blocks,
                                 block_size)
    split = pages * block_size  # keys of a verify split
    lens = [1, 0, block_size + block_size // 2, block_size * max_blocks,
            37, split, split + 1, 2 * split + 7, 1]
    batch = len(lens)
    heads = kv * group
    used = batch * max_blocks
    num_blocks = 1 + used + 1
    shape = (num_blocks, block_size, kv, head_dim)
    k_pool = torch.randn(shape, device="cuda", generator=gen)
    v_pool = torch.randn(shape, device="cuda", generator=gen)
    for pool in (k_pool, v_pool):
        pool[0] = poison
        pool[-1] = poison
    tables = (1 + torch.arange(used, device="cuda")).reshape(
        batch, max_blocks).to(torch.int32)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    positions = torch.clamp(seq_lens - window, min=0).to(torch.int32)
    for b in range(batch):
        covered = max(int(seq_lens[b]), int(positions[b]) + window)
        tables[b, -(-covered // block_size):] = num_blocks - 1
    tables[batch - 1] = 0  # inactive lane: reads the null block only
    q = torch.randn(batch, heads, head_dim, device="cuda", generator=gen)
    qv = torch.randn(batch, window, heads, head_dim, device="cuda",
                     generator=gen)
    return dict(
        q=q.to(dtype), qv=qv.to(dtype), k_pool=k_pool.to(dtype),
        v_pool=v_pool.to(dtype), tables=tables, seq_lens=seq_lens,
        positions=positions,
    )


def dropped_decode_split_ref(pk, q, k_pool, v_pool, tables, seq_lens):
    """The planted fault of B5: the plain decode with each lane's last
    split of pages dropped (its keys hidden; a lane whose keys fit in one
    split comes out as zeros), as when a kernel loses one split or the
    merge one partial."""
    bs, mb = k_pool.shape[1], tables.shape[1]
    pages = pk.verify_plan(1, 1, 1, mb, bs)[0]
    lens = seq_lens.long()
    n_pages = torch.clamp(torch.div(lens - 1, bs, rounding_mode="floor")
                          + 1, min=0, max=mb)
    first = torch.clamp(torch.div(n_pages - 1, pages, rounding_mode="floor")
                        * pages * bs, min=0)
    return pk.paged_decode_plain(q, k_pool, v_pool, tables,
                                 torch.minimum(lens, first).to(torch.int32))


def dropped_split_ref(pk, q, k_pool, v_pool, tables, positions):
    """The planted fault of B6: the plain verify with each lane's last
    split of pages dropped (keys from its first on hidden from every
    row), as when a kernel loses one split or the merge one partial."""
    b, c, nh, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    mb = tables.shape[1]
    pages, _, _ = pk.verify_plan(b, c * nh // nkv, nkv, mb, bs)
    horizon = positions.long() + c - 1
    n_pages = torch.clamp(horizon // bs + 1, max=mb)
    first = (n_pages - 1) // pages * pages * bs
    k = pk.gather_pool(k_pool, tables).float()
    v = pk.gather_pool(v_pool, tables).float()
    cols = torch.arange(k.shape[1], device=q.device)
    q_pos = positions.long()[:, None] + torch.arange(c, device=q.device)
    visible = ((cols[None, None] <= q_pos[:, :, None])
               & (cols[None, None] < first[:, None, None]))
    v = v.masked_fill(~visible[:, -1, :, None, None], 0.0)
    qg = q.float().reshape(b, c, nkv, nh // nkv, d)
    logits = torch.einsum("bckgd,btkd->bckgt", qg, k) * (d ** -0.5)
    p, denom = pk._masked_weights(logits, visible[:, :, None, None])
    out = torch.einsum("bckgt,btkd->bckgd", p, v) / denom
    return out.to(q.dtype).reshape(b, c, nh, d)


def paged_errs(out, ref, bad):
    """(max |out - ref|, max |out - bad|) over the live lanes (all but
    the last, inactive one, whose output the model discards)."""
    return max_err(out[:-1], ref[:-1]), max_err(out[:-1], bad[:-1])


def check_attention(pk, kind, group, dtype, poison, gen, head_dim):
    c = attention_case(pk, group, dtype, poison, gen, head_dim=head_dim)
    if kind == "decode":
        args = (c["q"], c["k_pool"], c["v_pool"], c["tables"], c["seq_lens"])
        out = pk.paged_decode_kernel(*args)
        torch.cuda.synchronize()
        ref = pk.paged_decode_plain(*args)
        bad = dropped_decode_split_ref(pk, *args)
        empty = out[1]
    else:
        args = (c["qv"], c["k_pool"], c["v_pool"], c["tables"],
                c["positions"])
        out = pk.paged_verify_kernel(*args)
        torch.cuda.synchronize()
        ref = pk.paged_verify_plain(*args)
        bad = dropped_split_ref(pk, *args)
        empty = None
    live = out[:-1]
    err, fault = paged_errs(out, ref, bad)
    ok = (
        err <= ATTN_TOL[dtype] < fault
        and bool(torch.isfinite(live).all())
        and float(live.float().abs().max()) < POISON / 10
        and (empty is None or bool((empty == 0).all()))
    )
    log(f"[check] paged_{kind} {str(dtype)[6:]} D={head_dim} group={group} "
        f"poison={poison} max_abs_err={err:.3g} with the last split dropped "
        f"{fault:.3g} tol={ATTN_TOL[dtype]} {'ok' if ok else 'FAIL'}")
    require(ok, f"paged_{kind} {dtype} D={head_dim} group={group} "
            f"poison={poison}")
    return err


def check_rms_fp32_weight(fused, n, d, gen):
    """bf16 ``x`` with an fp32 weight whose values bf16 cannot hold
    (``1 + 1e-3 randn``): the kernel must multiply by the weight as
    given.  A kernel that rounded it to bf16 would differ from the plain
    version in about a quarter of the outputs (one bf16 ulp each) and
    match the plain version of the rounded weight instead."""
    x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    w = 1 + 1e-3 * torch.randn(d, device="cuda", generator=gen)
    y, _ = fused.rms_norm_fwd(x, w, 1e-5)
    torch.cuda.synchronize()
    y_ref, _ = fused.rms_norm_plain(x, w, 1e-5)
    y_rounded, _ = fused.rms_norm_plain(x, w.to(torch.bfloat16), 1e-5)
    err = max_err(y, y_ref)
    mis = float((y != y_ref).float().mean())
    mis_rounded = float((y != y_rounded).float().mean())
    ok = err <= RMS_TOL[torch.bfloat16] and mis <= 1e-3 < mis_rounded
    log(f"[check] rms_norm bf16 x, fp32 weight N={n} D={d} "
        f"max_abs_err={err:.3g} differing={mis:.2e} (vs bf16-rounded "
        f"weight {mis_rounded:.2e}; need <= 1e-3 < it) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "rms_norm with an fp32 weight")
    return err


# Flash attention, kernel against plain version on the same inputs.
# o, dq, dk, dv: for every row (one query or key of one head),
# max_j |kernel - plain| over the row's D values, divided by the plain
# row's RMS plus 1e-2; the worst row must stay within "rows".  The
# inputs are unit-scale, so rows are 5e-4 (dv of the last key) to 4 in
# RMS; the 1e-2 is for rows that are 0 in exact arithmetic (dq and dk at
# S = 1 without an lse cotangent: p (dp - delta) cancels), where both
# versions give rounding noise of up to ~1e-6.  lse: max |kernel -
# plain|, an absolute limit (lse is a log: this is the relative error of
# the softmax denominator).  fp32: summation order only (the kernels use
# no TF32).  bf16: both versions round p, ds and the outputs to bf16
# from fp32 values that differ in their last bits, so an element can
# land one bf16 ulp apart.  Every check must also reject the same plain
# version with one (32 query rows x 64 keys) tile of the score matrix
# dropped (drop_tile).  Each limit sits between the two readings on the
# card: bf16 rows worst 0.032, dropped tile at least 0.38 (PERF.md).
FLASH_TOL = {torch.float32: {"rows": 1e-3, "lse": 1e-4},
             torch.bfloat16: {"rows": 1e-1, "lse": 1e-4}}
FLASH_OUT = {"flash_fwd": ("o", "lse"), "flash_bwd_dkv": ("dk", "dv"),
             "flash_bwd_dq": ("dq",)}


def poisoned(shape, dtype, gen, scale=1.0):
    """A tensor of ``shape`` at the start of a larger allocation whose
    tail is NaN: a kernel that reads past the end poisons its output."""
    n = int(np.prod(shape))
    buf = torch.full((n + 4096,), float("nan"), device="cuda", dtype=dtype)
    buf[:n] = (scale * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    return buf[:n].view(shape)


def row_err(got, ref) -> float:
    """Worst row of ``max |got - ref| / (RMS(ref row) + 1e-2)`` over the
    last dim; a NaN in one but not the other is infinite."""
    g, r = got.float(), ref.float()
    nan_g, nan_r = torch.isnan(g), torch.isnan(r)
    if not torch.equal(nan_g, nan_r):
        return float("inf")
    d = (g - r).abs().masked_fill(nan_g, 0.0).amax(-1)
    r = r.masked_fill(nan_r, 0.0)
    rms = r.square().mean(-1).sqrt()
    return float((d / (rms + 1e-2)).max()) if d.numel() else 0.0


def flash_errs(got, ref, dtype):
    """{output: error / its limit} for the outputs in both dicts."""
    tol = FLASH_TOL[dtype]
    return {n: (max_err(got[n], ref[n]) / tol["lse"] if n == "lse"
                else row_err(got[n], ref[n]) / tol["rows"])
            for n in got if n in ref}


def drop_tile(s):
    """The planted fault: the rows of the last 32-row query tile do not
    see the 64 keys from the 64-aligned middle of the sequence on, as
    when a kernel skips one tile of its loop (the forward's k loop, the
    dQ kernel's k loop, the dK/dV kernel's q loop).  None when S is too
    short for two tiles."""
    if s < 100:
        return None
    r0 = (s - 1) // 32 * 32
    c0 = s // 2 // 64 * 64
    return r0, c0, min(c0 + 64, s)


def faulted_refs(fa, q, k, v, dout, lse, delta, glse, causal, scale, ref):
    """The plain outputs ``ref`` (o, lse, dq, dk, dv) of a kernel that
    drops ``drop_tile``'s tile: the forward recomputed with the tile
    masked, the backward less the tile's share (p and ds from the given
    lse and delta, rounded as the plain version rounds them)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    r0, c0, c1 = drop_tile(s)
    sc, keep = fa._scores(q, k, causal, scale)
    if keep is not None:
        sc = sc.masked_fill(~keep, fa.NEG_INF)
    sc[..., r0:, c0:c1] = fa.NEG_INF
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = (o / den.permute(0, 3, 1, 2, 4)).to(q.dtype).reshape(b, s, h, d)
    out = {"o": o, "lse": (m + torch.log(den)).reshape(b, h, s)}
    del sc, p
    # the backward's share of the tile: [B, KV, G, rows, cols]
    qr = q[:, r0:].float().reshape(b, -1, kv, g, d)
    dor = dout[:, r0:].float().reshape(b, -1, kv, g, d)
    kc, vc = k[:, c0:c1].float(), v[:, c0:c1].float()
    rows = (b, kv, g, s - r0, 1)
    st = torch.einsum("bqkgd,bskd->bkgqs", qr, kc) * scale
    pt = torch.exp(st - lse[:, :, r0:].reshape(rows))
    corr = -delta[:, :, r0:].reshape(rows)
    if glse is not None:
        corr = corr + glse[:, :, r0:].reshape(rows)
    dst = pt * (torch.einsum("bqkgd,bskd->bkgqs", dor, vc) + corr) * scale
    pt, dst = pt.to(q.dtype).float(), dst.to(q.dtype).float()
    dq = ref["dq"].float().clone()
    dq[:, r0:] -= torch.einsum("bkgqs,bskd->bqkgd", dst, kc).reshape(
        b, -1, h, d)
    dk, dv = ref["dk"].float().clone(), ref["dv"].float().clone()
    dk[:, c0:c1] -= torch.einsum("bkgqs,bqkgd->bskd", dst, qr)
    dv[:, c0:c1] -= torch.einsum("bkgqs,bqkgd->bskd", pt, dor)
    out.update(dq=dq, dk=dk, dv=dv)
    return out


def bitwise_repeat(fn, runs: int = 3) -> bool:
    """Whether ``runs`` calls of ``fn`` (a tensor or a tuple of them)
    give outputs equal bit for bit: the backward kernels use no atomics,
    so a race in their pipeline shows as a difference."""
    outs = []
    for _ in range(runs):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        outs.append([t.view(torch.int16) if t.element_size() == 2
                     else t.view(torch.int32) for t in out])
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))


# kernel row name -> (source, a substring of the mangled name of the
# bf16 instantiation at head dim 128)
BUILT = {
    "paged_decode": ("paged_attention",
                     "decode_splitI13__nv_bfloat16Li128ELi1E"),
    "flash_fwd": ("flash_attention", "fwd_wgmmaILi128E"),
    "flash_bwd_dkv": ("flash_attention_bwd", "dkv_wgmmaILi128E"),
    "flash_bwd_dq": ("flash_attention_bwd", "dq_wgmmaILi128E"),
    "paged_verify": ("paged_attention",
                     "verify_splitI13__nv_bfloat16Li128ELi8E"),
}


def build_report(smem):
    """{kernel row: registers, spills and shared memory per block} of the
    Hopper-redesigned kernels from the ``-Xptxas -v`` log (registers,
    spill bytes, static shared memory) and ``smem[kernel]``, the
    launch's own dynamic shared memory."""
    from dlrover_tpu_torch.ops import _build

    report = {}
    for kern, (source, key) in BUILT.items():
        props, cur = {}, None
        for line in _build.build_logs.get(source, "").splitlines():
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"([\w$]+)", line)
            if m:
                cur = props.setdefault(m.group(1), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(m.group(1)) if m else 0
        found = [v for n, v in props.items() if key in n]
        row = dict(found[0]) if found else {"ptxas": "not in the log"}
        row["dynamic_smem"] = smem[kern]
        report[kern] = row
    return report


def kernel_smem():
    """The dynamic shared memory per block that each redesigned kernel's
    launch asks for at the main paths' shapes (bf16, head dim 128; the
    decode and verify splits over the serving pool's 16-key pages, the
    verify window's 4 rows)."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import paged_kernels as pk

    pages = pk.verify_plan(1, 4, 32, 128, 16)[0]
    return {"paged_decode": pk.decode_smem_bytes(torch.bfloat16, 128,
                                                 pages),
            "flash_fwd": fa.smem_bytes("fwd", 128),
            "flash_bwd_dkv": fa.smem_bytes("dkv", 128),
            "flash_bwd_dq": fa.smem_bytes("dq", 128),
            "paged_verify": pk.verify_smem_bytes(torch.bfloat16, 128, 4,
                                                 pages)}


def flash_case(fa, dtype, b, s, kv, group, d, causal, gen):
    """Forward, dK/dV and dQ kernels against their plain versions, the
    backward with the lse cotangent zero (None) and nonzero; each check
    must reject the plain version with a dropped tile (S >= 100).
    Returns {kernel: (worst error / limit, least faulted error /
    limit)}."""
    h = kv * group
    scale = d ** -0.5
    q = poisoned((b, s, h, d), dtype, gen)
    k = poisoned((b, s, kv, d), dtype, gen)
    v = poisoned((b, s, kv, d), dtype, gen)
    dout = poisoned((b, s, h, d), dtype, gen)
    glse = poisoned((b, h, s), torch.float32, gen)
    o, lse = fa.flash_fwd_kernel(q, k, v, causal, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    # the backward's saved inputs, from the plain forward on both sides
    lse_in = poisoned((b, h, s), torch.float32, gen)
    lse_in.copy_(lse_ref)
    delta = poisoned((b, h, s), torch.float32, gen)
    delta.copy_(fa.attention_delta(o_ref, dout))
    sound, fault = {}, {}
    for tag, g in (("", None), ("glse", glse)):
        args = (q, k, v, dout, lse_in, delta, g, causal, scale)
        dk, dv = fa.flash_bwd_dkv_kernel(*args)
        dq = fa.flash_bwd_dq_kernel(*args)
        torch.cuda.synchronize()
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*args)
        got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
        ref = dict(o=o_ref, lse=lse_ref, dq=fa.flash_bwd_dq_plain(*args),
                   dk=dk_ref, dv=dv_ref)
        for n, e in flash_errs(got, ref, dtype).items():
            sound[n] = max(sound.get(n, 0.0), e)
            if not bool(torch.isfinite(got[n]).all()):
                sound[n] = float("inf")
        if drop_tile(s) is not None:
            bad = faulted_refs(fa, *args, ref)
            for n, e in flash_errs(got, bad, dtype).items():
                fault[n] = min(fault.get(n, float("inf")), e)
    res = {}
    for kern, outs in FLASH_OUT.items():
        worst = max(sound[n] for n in outs)
        caught = max(fault[n] for n in outs) if fault else float("inf")
        res[kern] = (worst, caught)
    ok = all(w <= 1.0 < c for w, c in res.values())
    log(f"[check] flash {str(dtype)[6:]} B={b} S={s} KV={kv} G={group} "
        f"D={d} causal={int(causal)} err/limit "
        + " ".join(f"{n}={e:.3g}" for n, e in sound.items())
        + " dropped-tile err/limit "
        + (" ".join(f"{n}={e:.3g}" for n, e in fault.items()) or "-")
        + f" limits={FLASH_TOL[dtype]} {'ok' if ok else 'FAIL'}")
    require(ok, f"flash {dtype} S={s} G={group} D={d} causal={causal}")
    return res


def flash_checks():
    """B2-B4 over S in {1, 100, 128, 1000, 2048} (tails, a partly
    visible diagonal tile, one row), D in {16, 32, 64, 128} (bf16 runs
    the FMA kernels at 16 and 32, wgmma at 64 and 128), GQA groups 1/4/8,
    causal and not, bf16 and fp32, NaN past the end of every input; a
    dropped tile must be caught wherever S holds two tiles."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    summary = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = {k: [0.0, float("inf")] for k in FLASH_OUT}
        for d in (16, 32, 64, 128):
            for s in (1, 100, 128, 1000, 2048):
                for group in (1, 4, 8):
                    for causal in (True, False):
                        b = 2 if s <= 128 else 1
                        res = flash_case(fa, dtype, b, s, 2, group, d,
                                         causal, gen)
                        for kern, (w, c) in res.items():
                            worst[kern][0] = max(worst[kern][0], w)
                            worst[kern][1] = min(worst[kern][1], c)
        summary[str(dtype)[6:]] = worst
    log(f"[check] flash over all cases, [worst err, least dropped-tile "
        f"err] / limit: {summary}; the bf16 backward streams its 64-row "
        f"tiles through rings of 3 stages, so S = 1000 (16 tiles, the "
        f"last of 40 rows) and 2048 (32) wrap them many times")
    flash_train_shape(fa, gen)
    flash_small_d_times(fa, gen)


def flash_train_shape(fa, gen):
    """B2-B4 in bf16 at the training path's shape [4, 2048, 32, 128]
    causal on random inputs: three runs of each kernel equal bit for
    bit, and its time against its bound and SDPA's forward and backward
    (the captured input of the training leg is checked and timed again
    there)."""
    import torch.nn.functional as F

    b, s, h, d = 4, 2048, 32, 128
    scale = d ** -0.5
    q, k, v, dout = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    bargs = (q, k, v, dout, lse, fa.attention_delta(o, dout), None, True,
             scale)
    del o
    fns = {"flash_fwd": lambda: fa.flash_fwd_kernel(q, k, v, True, scale),
           "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_kernel(*bargs),
           "flash_bwd_dq": lambda: fa.flash_bwd_dq_kernel(*bargs)}
    same = {n: bitwise_repeat(fn) for n, fn in fns.items()}
    log(f"[check] flash [{b}, {s}, {h}, {d}] bf16 causal, random inputs, "
        f"3 runs of each kernel equal bit for bit: {same}")
    require(all(same.values()), "a flash kernel is not deterministic")
    ms = {n: cuda_ms(fn) for n, fn in fns.items()}
    bnd = {"flash_fwd": flash_bound_ms("fwd", q, k)[0],
           "flash_bwd_dkv": flash_bound_ms("dkv", q, k)[0],
           "flash_bwd_dq": flash_bound_ms("dq", q, k)[0]}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    with torch.no_grad():
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dout_t = dout.transpose(1, 2).contiguous()
    sdpa_ms = events_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dout_t, retain_graph=True))
    log(f"[time] flash [{b}, {s}, {h}, {d}] bf16 causal, random inputs: "
        + " ".join(f"{n} ms={ms[n]:.4f} bound_ms={bnd[n]:.4f} "
                   f"bound/ms={bnd[n] / ms[n]:.3f}" for n in ms)
        + f" SDPA forward ms={sdpa_fwd_ms:.4f} dkv+dq ms="
        f"{ms['flash_bwd_dkv'] + ms['flash_bwd_dq']:.4f} SDPA backward ms="
        f"{sdpa_ms:.4f}; {build_report(kernel_smem())}")
    del qt, kt, vt, out_t, dout_t, q, k, v, dout, lse, bargs, fns
    torch.cuda.empty_cache()


def flash_small_d_times(fa, gen):
    """B2-B4 at head_dim 16 and 32, where bf16 runs the FMA kernels (no
    tensor cores): times at ``[4, 2048, 4, D]`` causal with 2 KV heads
    (``LlamaConfig.tiny()``'s heads at a training sequence length), bf16,
    random inputs, beside their bounds and SDPA's forward and backward
    (SDPA on the KV heads repeated to 4)."""
    import torch.nn.functional as F

    b, s, h, kv = 4, 2048, 4, 2
    for d in (16, 32):
        scale = d ** -0.5
        q, dout = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, s, kv, d, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
        bargs = (q, k, v, dout, lse, fa.attention_delta(o, dout), None,
                 True, scale)
        fns = {"flash_fwd": lambda: fa.flash_fwd_kernel(q, k, v, True, scale),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_kernel(*bargs),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq_kernel(*bargs)}
        ms = {n: cuda_ms(fn) for n, fn in fns.items()}
        bnd = {n: flash_bound_ms(kind, q, k)[0] for n, kind in (
            ("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
            ("flash_bwd_dq", "dq"))}
        qt, kt, vt = (t.transpose(1, 2).repeat_interleave(h // t.shape[2], 1)
                      .contiguous().requires_grad_(True) for t in (q, k, v))
        with torch.no_grad():
            sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
        out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dout_t = dout.transpose(1, 2).contiguous()
        sdpa_bwd = events_ms(lambda: torch.autograd.grad(
            out_t, (qt, kt, vt), dout_t, retain_graph=True))
        log(f"[time] flash [{b}, {s}, {h}, {d}] KV={kv} bf16 causal (FMA "
            f"kernels), random inputs: "
            + " ".join(f"{n} ms={ms[n]:.4f} bound_ms={bnd[n]:.4f} "
                       f"bound/ms={bnd[n] / ms[n]:.3f}" for n in ms)
            + f" SDPA forward ms={sdpa_fwd:.4f} SDPA backward ms="
            f"{sdpa_bwd:.4f}; smem per block fwd/dkv/dq "
            f"{[fa.smem_bytes(x, d) for x in ('fwd', 'dkv', 'dq')]}")
        del q, k, v, dout, o, lse, bargs, fns, qt, kt, vt, out_t, dout_t
    torch.cuda.empty_cache()


def serving_window(gen, lanes=13, heads=32, head_dim=128, block_size=16,
                   max_blocks=128, window=4):
    """A verify window at the serving path's shape without the model:
    Llama-2-7B's 32 KV heads of 128 over a 2049-block bf16 pool, 13
    lanes at positions 142-1062 (prompts from the serving leg's seed plus
    up to 64 new tokens), pages spread over the pool."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 1025, size=16)[:lanes] + rng.integers(
        0, 64, size=lanes)
    num_blocks = 1 + 2048
    shape = (num_blocks, block_size, heads, head_dim)
    k_pool = torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    v_pool = torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    perm = torch.from_numpy(1 + rng.permutation(2048)[:lanes * max_blocks])
    tables = perm.reshape(lanes, max_blocks).to(torch.int32).cuda()
    positions = torch.from_numpy(lens).to(torch.int32).cuda()
    qv = torch.randn(lanes, window, heads, head_dim, device="cuda",
                     generator=gen).to(torch.bfloat16)
    return qv, k_pool, v_pool, tables, positions


def paged_serving_shape(pk, gen):
    """B6 at the serving shape on a synthetic window (``serving_window``):
    against its plain version, three runs equal bit for bit, its time
    beside its bound, the plain version and SDPA (the captured window of
    the serving leg is checked and timed again there)."""
    a = serving_window(gen)
    out = pk.paged_verify_kernel(*a)
    torch.cuda.synchronize()
    ref = pk.paged_verify_plain(*a)
    err, fault = max_err(out, ref), max_err(out, dropped_split_ref(pk, *a))
    same = bitwise_repeat(lambda: pk.paged_verify_kernel(*a))
    ok = err <= ATTN_TOL[torch.bfloat16] < fault and same
    ms = cuda_ms(lambda: pk.paged_verify_kernel(*a))
    plain_ms = cuda_ms(lambda: pk.paged_verify_plain(*a), reps=3)
    lib_ms = cuda_ms(sdpa_decode_fn(*a, 4))
    bnd = attn_bound_ms(a[0], a[1], a[4], 4)[0]
    log(f"[check] paged_verify serving shape q={tuple(a[0].shape)} "
        f"pos={a[4].tolist()} max_abs_err={err:.3g} with the last split "
        f"dropped {fault:.3g} tol={ATTN_TOL[torch.bfloat16]}; 3 runs equal "
        f"bit for bit: {same} {'ok' if ok else 'FAIL'}")
    log(f"[time] paged_verify serving shape ms={ms:.4f} bound_ms={bnd:.4f} "
        f"bound/ms={bnd / ms:.3f} plain_ms={plain_ms:.4f} library_ms="
        f"{lib_ms:.4f}")
    require(ok, "paged_verify at the serving shape")
    del a, out, ref
    torch.cuda.empty_cache()


def sampling_check():
    """The T > 0 sampler on the card against the CPU, same (seed,
    position, vocab): the threefry noise bits equal bit for bit, and
    the sampled tokens of the same logits equal; the Gumbel noise's
    largest difference (each side's own ``log``) is printed."""
    from dlrover_tpu_torch.rl import sampling

    seeds = torch.tensor([0, 2**31 + 5, 2**32 + 3])[:, None]
    pos = torch.tensor([0, 7, 10**6])[None]
    vocab = 32000
    bits = sampling.noise_bits(seeds, pos, vocab)
    bits_card = sampling.noise_bits(seeds.cuda(), pos.cuda(), vocab)
    g = sampling.gumbel_noise(seeds, pos, vocab)
    g_card = sampling.gumbel_noise(seeds.cuda(), pos.cuda(), vocab)
    logits = torch.randn(3, 3, vocab, generator=torch.Generator()
                         .manual_seed(SEED))
    toks = sampling.sample_tokens(logits, seeds, pos, 0.8)
    toks_card = sampling.sample_tokens(logits.cuda(), seeds.cuda(),
                                       pos.cuda(), 0.8)
    same_bits = torch.equal(bits_card.cpu(), bits)
    same_toks = torch.equal(toks_card.cpu(), toks)
    log(f"[check] sampling noise bits card == CPU bit for bit over seeds "
        f"{seeds.flatten().tolist()} x positions {pos.flatten().tolist()} x "
        f"vocab {vocab}: {same_bits}; Gumbel max |card - CPU| "
        f"{max_err(g_card.cpu(), g):.3g}; T=0.8 tokens equal: {same_toks}")
    require(same_bits and same_toks, "the sampler differs on the card")


# RMSNorm shapes: one row to a full training batch (the many-rows kernel
# from 8 rows per SM on: 2048 x 4096 bf16, 1200 x 2048 fp32), D not a
# multiple of 8 and 16-byte vectors (the scalar path), a row too long
# for registers (the strided loops), and x one element off a 16-byte
# boundary (the scalar path)
RMS_SHAPES = ((1, 4096), (16, 4096), (52, 4096), (257, 4096), (64, 8192),
              (2048, 4096), (1200, 2048), (37, 100), (3, 40000))


def rms_checks(fused, gen):
    for n, d in ((16, 4096), (4 * 2048, 4096)):
        check_rms_fp32_weight(fused, n, d, gen)
        check_add_rms(fused, torch.bfloat16, n, d, gen, torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        for n, d in RMS_SHAPES:
            check_rms(fused, dtype, n, d, gen)
            check_add_rms(fused, dtype, n, d, gen)
        check_rms(fused, dtype, 16, 4096, gen, offset=1)
        check_add_rms(fused, dtype, 16, 4096, gen, offset=1)
    # the backward: the training shape with and without the residual
    # gradient, decode rows, fp32 rows past the registers (the strided
    # loop), D = 100 (scalar), a row of 40,000 (strided), tiny
    for dtype, w_dtype, n, d, res in (
            (torch.bfloat16, torch.float32, 8192, 4096, True),
            (torch.bfloat16, torch.float32, 8192, 4096, False),
            (torch.bfloat16, torch.bfloat16, 16, 4096, True),
            (torch.float32, torch.float32, 257, 4096, False),
            (torch.float32, torch.float32, 64, 2048, True),
            (torch.bfloat16, torch.float32, 37, 100, True),
            (torch.bfloat16, torch.bfloat16, 5, 40000, True),
            (torch.float32, torch.float32, 3, 64, False)):
        check_rms_bwd(fused, dtype, w_dtype, n, d, res, gen)
    torch.cuda.empty_cache()


def kernel_checks():
    from dlrover_tpu_torch.ops import fused
    from dlrover_tpu_torch.ops import paged_kernels as pk

    gen = torch.Generator(device="cuda").manual_seed(0)
    rms_checks(fused, gen)
    for dtype in (torch.bfloat16, torch.float32):
        for kind in ("decode", "verify"):
            for head_dim in (16, 32, 64, 128, 256):
                for group in (1, 4, 8):
                    for poison in (POISON, float("nan")):
                        check_attention(pk, kind, group, dtype, poison, gen,
                                        head_dim)
    paged_serving_shape(pk, gen)
    sampling_check()


# ----------------------------------------------------------- main path


def tiny_parity():
    """End to end against the plain path: ``LlamaConfig.tiny()`` at its
    own widths (dim 64, 4 heads, 2 KV heads, head_dim 16) in fp32, served
    on the card (kernels) and on the CPU (plain versions) from the same
    params, must give the same tails, greedy and at temperature 0.8, for
    K=1 and the K=3 window, on a pool small enough to force preemption
    and resume."""
    from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
    from dlrover_tpu_torch.rl.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerConfig,
    )

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v.cuda()) for k, v in cpu.items()}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(2, 10, size=6)]
    env = {"DLROVER_TPU_KV_ADMIT_WATERMARK": "0",
           "DLROVER_TPU_KV_GROW_BLOCKS": "1"}
    saved = {k: os.environ.get(k) for k in [*env, "DLROVER_TPU_DECODE_STEPS"]}
    os.environ.update(env)
    try:
        for temp in (0.0, 0.8):
            sched = SchedulerConfig(max_slots=4, block_size=4, num_blocks=9,
                                    max_seq_len=64, prefill_chunk=3,
                                    temperature=temp)
            for k in (1, 3):
                os.environ["DLROVER_TPU_DECODE_STEPS"] = str(k)
                tails, counts = [], []
                for device, params in (("cpu", cpu), ("cuda", gpu)):
                    sch = ContinuousBatchingScheduler(cfg, sched,
                                                      device=device)
                    sch.sync_weights(params)
                    for i, p in enumerate(prompts):
                        sch.submit(p, max_new=12, seed=i)
                    tails.append({r.req_id: r.tokens for r in sch.run()})
                    st = sch.stats()
                    counts.append({n: st[n] for n in (
                        "preemptions", "accepted_tokens", "lane_windows")})
                same = tails[0].keys() == tails[1].keys() and all(
                    np.array_equal(tails[0][i], tails[1][i])
                    for i in tails[0])
                # at temperature 0 the tails are the draft (decode)
                # stream; only the acceptance counts read the verify
                # kernel's output
                log(f"[parity] tiny fp32 head_dim={cfg.head_dim} T={temp} "
                    f"K={k}: card tails == CPU tails: {same}; cpu "
                    f"{counts[0]} card {counts[1]}")
                require(same and counts[0] == counts[1]
                        and counts[1]["preemptions"] >= 1,
                        f"tiny fp32 T={temp} K={k}: card and CPU disagree")
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def _copy(t):
    return t.detach().clone() if isinstance(t, torch.Tensor) else None


class Capture:
    """Wraps one kernel entry of ``models.llama``.  Among the calls it
    considers (every ``every``-th: layer 0 of each step), it keeps a
    copy of the inputs and the output of the first one at the highest
    ``score()`` (serving: the number of lanes decoding, read on the
    host; a constant keeps the first call)."""

    def __init__(self, module, attr, score, every=1, when=None):
        self.module, self.attr = module, attr
        self.score, self.every = score, every
        self.when = when or (lambda *a: True)
        self.orig = getattr(module, attr)
        self.calls = 0
        self.best = -1
        self.args = None
        self.out = None
        setattr(module, attr, self)

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        if self.calls % self.every == 0 and self.when(*args):
            score = self.score()
            if score > self.best:
                self.best = score
                self.args = tuple(
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args
                )
                self.out = (tuple(map(_copy, out)) if isinstance(out, tuple)
                            else _copy(out))
        self.calls += 1
        return out

    def restore(self):
        setattr(self.module, self.attr, self.orig)


def profile_step(step, label):
    """Run one decode step under ``torch.profiler`` and print where its
    device time goes: total kernel time, kernel launches, the device's
    busy share of the step's wall time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side copies of host annotations ("Optimizer.step#AGD.step")
    # span kernels already counted: leave them out
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA
        and not e.key.startswith("Optimizer.")
    ]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    # device-to-device copies (the scheduler's, varying from step to
    # step) are counted apart from the kernel launches
    copies = sum(e.count for e in kernels if e.key.startswith("Memcpy"))
    launches = sum(e.count for e in kernels) - copies
    log(f"[profile] {label}: wall_ms={wall_ms:.3f} (profiler on) "
        f"device_kernel_ms={total_ms:.3f} kernel_launches={launches} "
        f"copies={copies} device_busy_share={total_ms / wall_ms:.3f}")
    # the residual adds (a bf16 add kernel of their own unless fused into
    # the norm) and the RMSNorm kernels, by name
    for what, keys in (("bf16 adds", ("CUDAFunctor_add", "BFloat16")),
                       ("RMSNorm kernels", ("rms_",))):
        sel = [e for e in kernels if all(k in e.key for k in keys)]
        log(f"[profile]   {what}: {sum(e.count for e in sel)} launches, "
            f"{sum(dev_us(e) for e in sel) / 1e3:.3f} ms")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    # where the host's time goes: its own ops and the CUDA runtime calls
    # (a synchronising call names what holds the host back)
    host = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) != DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"[profile]   host {e.self_cpu_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    return n


def serve_leg(cfg, params, sched_cfg, prompts, k, max_new, captures,
              profile=False):
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.rl.scheduler import ContinuousBatchingScheduler

    os.environ["DLROVER_TPU_DECODE_STEPS"] = str(k)
    sch = ContinuousBatchingScheduler(cfg, sched_cfg)
    sch.sync_weights(params)
    decode_s, full_s, step_events = [], [], []
    inner = sch._decode_multi_once if k > 1 else sch._decode_once
    lanes = sched_cfg.max_slots
    profiled = []

    def timed(finished):
        full = int(sch._active.sum()) == lanes
        if profile and full and not profiled:
            profiled.append(True)
            return profile_step(lambda: inner(finished),
                                f"K={k} decode step, {lanes} lanes")
        t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        n = inner(finished)
        ev[1].record()
        if n:  # the step ends in a host copy of the sampled tokens
            decode_s.append(time.perf_counter() - t0)
            step_events.append(ev)
            if full:
                full_s.append(decode_s[-1])
        return n

    if k > 1:
        sch._decode_multi_once = timed
    else:
        sch._decode_once = timed
    active = lambda: int(sch._active.sum())  # noqa: E731
    caps = [Capture(llama, score=active, **c) for c in captures]
    # the model forwards of the step with the most lanes decoding, for
    # their device time (CUDA-graph replays, no host gaps)
    fwds = [Capture(llama, "paged_decode_step", active)]
    if k > 1:
        fwds.append(Capture(llama, "paged_verify_step", active))
    for i, p in enumerate(prompts):
        sch.submit(p, max_new=max_new, seed=100 + i)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    results = sch.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    for c in caps + fwds:
        c.restore()
    stats = sch.stats()
    # the card's clock from each step's start to its end, host gaps
    # included; and the device time of the step's forwards alone: K
    # decode forwards (+ the verify forward) at the captured inputs
    events_ms = statistics.median(a.elapsed_time(b) for a, b in step_events)
    fwd_ms = [cuda_ms(lambda c=c: getattr(llama, c.attr)(*c.args), reps=3)
              for c in fwds]
    device_ms = k * fwd_ms[0] + sum(fwd_ms[1:])
    fwd_lanes = fwds[0].best
    del sch, fwds
    torch.cuda.empty_cache()
    tails = {r.req_id: r.tokens[len(prompts[r.req_id]):] for r in results}
    require(len(tails) == len(prompts), f"K={k}: not every request ended")
    for r in results:
        require(r.new_tokens == max_new, f"K={k}: short tail {r.req_id}")
    new_tokens = sum(len(t) for t in tails.values())
    step_ms = 1e3 * statistics.median(decode_s)
    full_ms = 1e3 * statistics.median(full_s) if full_s else float("nan")
    what = "window" if k > 1 else "step"
    log(f"[serve] K={k} requests={len(results)} new_tokens={new_tokens} "
        f"wall_s={wall:.3f} tokens_per_s={new_tokens / wall:.1f} "
        f"decode_{what}_ms_median={step_ms:.3f} "
        f"decode_{what}_ms_median_all_{lanes}_lanes={full_ms:.3f} "
        f"decode_{what}s={len(decode_s)} (all lanes: {len(full_s)}) "
        f"decode_{what}_events_ms_median={events_ms:.3f} (card clock, host "
        f"gaps included) decode_{what}_device_ms={device_ms:.3f} ({k} x "
        f"decode forward {fwd_ms[0]:.3f}"
        + (f" + verify forward {fwd_ms[1]:.3f}" if k > 1 else "")
        + f", CUDA-graph replays of the captured step, {fwd_lanes} lanes "
        f"decoding) "
        f"iterations={stats['iterations']} "
        f"accepted_per_window={stats['accepted_per_step']} "
        f"preemptions={stats['preemptions']} launches={counts}")
    for c in caps:
        log(f"[serve] K={k} captured {c.attr} with {c.best} lanes "
            "decoding")
    if profile and not profiled:
        log(f"[profile] K={k}: no decode step had all {lanes} lanes "
            "decoding; nothing traced")
    return tails, counts, caps, stats


def rms_bound_ms(x, w, add=False):
    """Bytes: x (and delta) read, y (and h) written, w and rstd once."""
    n, d = x.numel() // x.shape[-1], x.shape[-1]
    item = x.element_size()
    nbytes = (4 if add else 2) * n * d * item + d * w.element_size() + 4 * n
    return bound(nbytes, (5 if add else 4) * n * d, x.dtype)


def attn_bound_ms(q, k_pool, lens, window):
    """Bytes: q and the output once, every K and V row some query of
    the call may see (seq_len rows per lane for decode, pos + C for
    verify), the table entries of those pages and the lengths.
    Operations: 4 * D per (query head, visible key) pair."""
    _, bs, kv, d = k_pool.shape
    item = q.element_size()
    heads = q.shape[-2]
    lens = lens.long().clamp(min=0)
    if window is None:
        rows = lens
        pairs = int(lens.sum())
    else:
        rows = lens + window
        pairs = int((window * lens + window * (window + 1) // 2).sum())
    pages = int(((rows + bs - 1) // bs).sum())
    nbytes = 2 * q.numel() * item + 2 * int(rows.sum()) * kv * d * item
    nbytes += 4 * (pages + lens.numel())
    return bound(nbytes, 4 * pairs * heads * d, q.dtype)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_decode_fn(q, k_pool, v_pool, tables, lens, window):
    """The library yardstick: SDPA over a cache gathered beforehand
    (the port never calls it)."""
    import torch.nn.functional as F

    b = q.shape[0]
    _, bs, kv, d = k_pool.shape
    heads = q.shape[-2]
    g = heads // kv
    t = tables.shape[1] * bs
    k = k_pool[tables.long()].reshape(b, t, kv, d).transpose(1, 2)
    v = v_pool[tables.long()].reshape(b, t, kv, d).transpose(1, 2)
    k = k.repeat_interleave(g, dim=1).contiguous()
    v = v.repeat_interleave(g, dim=1).contiguous()
    cols = torch.arange(t, device=q.device)
    if window is None:
        qq = q[:, :, None, :]  # [B, H, 1, D]
        mask = (cols[None] < lens[:, None])[:, None, None, :]
    else:
        qq = q.transpose(1, 2).contiguous()  # [B, H, C, D]
        qpos = lens[:, None] + torch.arange(window, device=q.device)
        mask = (cols[None, None] <= qpos[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def log_row(r):
    lib = r["library_ms"]
    log(f"[time] {r['name']} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"library_ms={'null' if lib is None else format(lib, '.4f')} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bound/ms="
        f"{r['bound_share']:.3f} launches={r['launches']} "
        + " ".join(f"{k}={r[k]}" for k in ("library_unfused_ms",
                                          "library_note", "build")
                   if k in r))


def kernel_row(name, source, replaces, launches, err, tol, fn, plain,
               library, bnd):
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, reps=3)
    library_ms = cuda_ms(library) if library is not None else None
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
        "bound_by": bnd[1], "bound_share": bnd[0] / ms,
        "library_ms": library_ms,
    }


def rms_rows(fused, rms, add, launches, suffix):
    """The kernel rows of the two forward entries on their captured
    inputs: each
    rerun must equal the main path's output and stay within RMS_TOL of
    its plain version.  Both entries count under the one launch key
    ``rms_norm``.  No single PyTorch call adds and normalises: the
    residual entry's ``library_ms`` is null, and the unfused ``x + delta``
    then ``F.rms_norm`` is timed beside it."""
    import torch.nn.functional as F

    x, w, eps = rms.args
    x2 = x.reshape(-1, x.shape[-1])
    y, _ = fused.rms_norm_fwd(x2, w, eps)
    require(torch.equal(y.reshape(rms.out.shape), rms.out),
            "rms_norm rerun differs from the main path's output")
    err = max_err(y, fused.rms_norm_plain(x2, w, eps)[0])
    log(f"[captured] rms_norm{suffix} {tuple(x.shape)} {x.dtype} x, "
        f"{w.dtype} weight max_abs_err={err:.3g} tol={RMS_TOL[x.dtype]}")
    require(err <= RMS_TOL[x.dtype], "rms_norm on the captured input")
    src = "dlrover_tpu_torch/ops/csrc/rms_norm.cu"
    rows = [kernel_row(
        f"rms_norm{suffix}", src, "dlrover_tpu/ops/fused.py:48", launches,
        err, RMS_TOL[x.dtype],
        lambda: fused.rms_norm_fwd(x2, w, eps),
        lambda: fused.rms_norm_plain(x2, w, eps),
        # for a weight of another dtype PyTorch runs it unfused
        lambda: F.rms_norm(x2, (x2.shape[-1],), w, eps),
        rms_bound_ms(x2, w),
    )]
    rows[0]["launch_key"] = "rms_norm (both entries)"
    xa, delta, wa, eps = add.args
    xa2, da2 = xa.reshape(-1, xa.shape[-1]), delta.reshape(-1, xa.shape[-1])
    h, ya, _ = fused.add_rms_norm_fwd(xa2, da2, wa, eps)
    require(torch.equal(h.reshape(add.out[0].shape), add.out[0])
            and torch.equal(ya.reshape(add.out[1].shape), add.out[1]),
            "add_rms_norm rerun differs from the main path's output")
    h_ref, ya_ref, _ = fused.add_rms_norm_plain(xa2, da2, wa, eps)
    err_a = max_err(ya, ya_ref)
    log(f"[captured] add_rms_norm{suffix} {tuple(xa.shape)} h equal: "
        f"{torch.equal(h, h_ref)} max_abs_err={err_a:.3g} "
        f"tol={RMS_TOL[x.dtype]}")
    require(err_a <= RMS_TOL[x.dtype] and torch.equal(h, h_ref),
            "add_rms_norm on the captured input")
    rows.append(kernel_row(
        f"add_rms_norm{suffix}", src, "dlrover_tpu/ops/fused.py:48",
        launches, err_a, RMS_TOL[x.dtype],
        lambda: fused.add_rms_norm_fwd(xa2, da2, wa, eps),
        lambda: fused.add_rms_norm_plain(xa2, da2, wa, eps),
        None, rms_bound_ms(xa2, wa, add=True),
    ))
    rows[1].update(launch_key="rms_norm (both entries)",
                   library_unfused_ms=cuda_ms(lambda: F.rms_norm(
                       xa2 + da2, (xa2.shape[-1],), wa, eps)))
    return rows


def rms_bwd_bound_ms(x, w, res):
    """Bytes: x, g, g_res (if any) and dx once, w read and dw written once,
    rstd once.  Operations: 10 fp32 per element (xhat, dxhat, the dot's
    multiply and add, dx's three, the residual add, dw's two)."""
    n, d = x.numel() // x.shape[-1], x.shape[-1]
    nbytes = (4 if res else 3) * n * d * x.element_size()
    nbytes += 2 * d * w.element_size() + 4 * n
    return bound(nbytes, 10 * n * d, torch.float32)


def main_path(args):
    from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
    from dlrover_tpu_torch.ops import fused
    from dlrover_tpu_torch.ops import paged_kernels as pk
    from dlrover_tpu_torch.rl.scheduler import SchedulerConfig

    cfg = LlamaConfig.llama2_7b(n_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(
        t.numel() for t in [params["embed"], params["final_norm"],
                            params["lm_head"], *params["layers"].values()]
    )
    log(f"[main] Llama-2-7B width, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f}B params in {cfg.dtype}, "
        f"init_s={time.perf_counter() - t0:.2f}")
    sched_cfg = SchedulerConfig(
        max_slots=16, block_size=16, num_blocks=2049, max_seq_len=2048,
        prefill_chunk=256, temperature=0.0,
    )
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 1025, size=args.requests)
    prompts = [
        rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
        for n in lens
    ]
    log(f"[main] prompts={args.requests} lens={lens.tolist()} "
        f"max_new={args.max_new} pool_GiB="
        f"{2 * cfg.n_layers * 2049 * 16 * cfg.n_kv_heads * cfg.head_dim * 2 / 2**30:.2f}")
    L = cfg.n_layers
    # layer 0 of the first decode step (and verify window) with the
    # most lanes decoding; the RMSNorm input of that step's layer 0
    decoding = lambda x, *_: tuple(x.shape[:2]) == (16, 1)  # noqa: E731
    tails1, counts1, caps1, _ = serve_leg(
        cfg, params, sched_cfg, prompts, 1, args.max_new,
        [dict(attr="paged_decode_attention", every=L)]
        + [dict(attr=n, when=decoding)
           for n in ("rms_norm", "add_rms_norm")],
        profile=args.profile,
    )
    tails4, counts4, caps4, stats4 = serve_leg(
        cfg, params, sched_cfg, prompts, 4, args.max_new,
        [dict(attr="paged_verify_attention", every=L)],
        profile=args.profile,
    )
    for key in ("rms_norm", "paged_decode"):
        require(counts1[key] > 0, f"K=1 leg launched no {key}")
    for key in ("rms_norm", "paged_decode", "paged_verify"):
        require(counts4[key] > 0, f"K=4 leg launched no {key}")
    require(counts1["paged_verify"] == 0, "K=1 leg launched verify")
    same = all(np.array_equal(tails1[i], tails4[i]) for i in tails1)
    log(f"[main] greedy tails identical K=1 vs K=4: {same}")
    require(same, "greedy tails differ between K=1 and K=4")
    # the K=4 tails are the draft stream whatever verify returns; a
    # verify that disagrees with the drafts accepts 1 token per window
    acc = stats4["accepted_per_step"]
    log(f"[main] K=4 accepted tokens per window {acc} "
        f"(floor {ACCEPT_FLOOR})")
    require(acc >= ACCEPT_FLOOR, "K=4 verify accepts too few drafts")
    del params
    torch.cuda.empty_cache()

    launches = {k: counts1[k] + counts4[k] for k in counts1}
    dec, rms, add = caps1
    ver = caps4[0]
    require(all(c.args is not None for c in caps1 + caps4),
            "a capture point was never reached")
    # RMSNorm on the captured decode-step inputs: layer 0's attention
    # norm (no add before it) and its MLP norm (the add of wo's output)
    rows = rms_rows(fused, rms, add, launches["rms_norm"], "")

    report = build_report(kernel_smem())
    for name, cap, window, replaces, kern, plain, faulted in (
        ("paged_decode", dec, None, "dlrover_tpu/ops/paged_kernels.py:128",
         pk.paged_decode_kernel, pk.paged_decode_plain,
         dropped_decode_split_ref),
        ("paged_verify", ver, 4, "dlrover_tpu/ops/paged_kernels.py:289",
         pk.paged_verify_kernel, pk.paged_verify_plain, dropped_split_ref),
    ):
        a = cap.args
        out = kern(*a)
        ref = plain(*a)
        require(torch.equal(out, cap.out),
                f"{name} rerun differs from the main path's output")
        err = max_err(out, ref)
        fault = max_err(out, faulted(pk, *a))
        log(f"[captured] {name} q={tuple(a[0].shape)} "
            f"lens/pos={a[4].tolist()} max_abs_err={err:.3g} with the "
            f"last split dropped {fault:.3g} tol={ATTN_TOL[a[0].dtype]}")
        require(err <= ATTN_TOL[a[0].dtype] < fault,
                f"{name} on captured input, or its check cannot see the "
                "planted fault")
        same = bitwise_repeat(lambda: kern(*a))
        log(f"[check] {name} on the captured input, 3 runs equal bit for "
            f"bit: {same}")
        require(same, f"{name} is not deterministic")
        row = kernel_row(
            name, "dlrover_tpu_torch/ops/csrc/paged_attention.cu", replaces,
            launches[name], err, ATTN_TOL[a[0].dtype],
            lambda: kern(*a), lambda: plain(*a),
            sdpa_decode_fn(*a, window),
            attn_bound_ms(a[0], a[1], a[4], window),
        )
        row["planted_fault_err"] = fault
        if name in report:
            row["build"] = report[name]
        rows.append(row)
    for r in rows:
        log_row(r)
    return rows


# ------------------------------------------------------------ training


# fp32 card (kernels, cuBLAS without TF32) against CPU (plain versions)
# over 3 AGD steps: sums in another order; AGD's sign-like step moves a
# parameter by up to lr * (relative gradient difference) / delta.
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "params": 2e-5}
# the same over 3 QuantizedMoments steps: a payload may land one count
# apart (on at most 1 in 10^3 elements) where the grads differ in their
# last bits, so params are held by each leaf's whole update (L2 of the
# difference over L2 of the CPU's update)
INT8_TRAIN_TOL = {"payload_frac": 1e-3, "update_rel": 1e-2}
# bf16 step 0 at full width, flash kernels against the dense plain
# attention on the card.  Loss and grad norm are dominated by the lm
# head and the embedding, so they only show that the step is sound as a
# whole.  The attention backward is read in the grads of wq, wk and wv:
# per layer, |g_flash - g_dense| / |g_dense| (L2 over the layer's
# matrix), worst over layers and the three leaves.  Its limit sits
# between the sound reading and that of a planted fault, dq zeroed (q
# detached before the flash call), which must exceed it.
STEP0_TOL = {"loss": 1e-2, "grad_norm": 3e-2, "attn_grads": 0.1}
# tiny bf16 card against CPU (bf16_train_parity): step 0's grads per leaf
# (the limit sits between the sound reading and that of dq zeroed), and
# loss and grad norm over 3 AGD steps
BF16_TRAIN_TOL = {"grads": 0.1, "loss": 2e-2, "grad_norm": 5e-2}
TRAIN_KERNELS = ("rms_norm", "rms_norm_bwd", "flash_fwd", "flash_bwd_dkv",
                 "flash_bwd_dq")


def _clone_to(tree, device):
    if isinstance(tree, dict):
        return {k: _clone_to(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


def _train_run(cfg, params, batches, device, make_opt, attention_fn=None):
    """``auto_accelerate`` + ``train_step`` from a copy of ``params`` on
    ``device``: per-step metrics, the final params and the optimizer."""
    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models.llama import loss_fn

    kw = {} if attention_fn is None else {"attention_fn": attention_fn}
    result = auto_accelerate(
        loss_fn=lambda p, b: loss_fn(p, b, cfg, **kw),
        optimizer=make_opt,
        init_params_fn=lambda gen, dev: _clone_to(params, dev),
        device=device,
    )
    state = result.fns.init_state(SEED)
    metrics = []
    for b in batches:
        state, m = result.fns.train_step(
            state, {"tokens": torch.from_numpy(b).to(device)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, _clone_to(state["params"], "cpu"), state["opt_state"]


def train_parity():
    """``LlamaConfig.tiny()`` at its own widths (head_dim 16, GQA group
    2) trained for 3 steps on the card (flash, RMSNorm and, for the int8
    optimizer, B7/B9 kernels) and on the CPU (plain versions) from the
    same params and batches, with AGD and with ``QuantizedMoments`` in
    fp32: losses, grad norms and final params agree; then AGD in bf16
    (``bf16_train_parity``)."""
    from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.optimizers import AGD, QuantizedMoments

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                         dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int64)
               for _ in range(3)]
    for label, make_opt, kernels in (
        ("AGD", lambda ps: AGD(ps, lr=1e-3), TRAIN_KERNELS),
        # the int8 leg's optimizer
        ("QuantizedMoments", lambda ps: QuantizedMoments(
            ps, lr=3e-4, weight_decay=0.1),
         TRAIN_KERNELS + ("quantize", "int8_adam")),
    ):
        cpu_metrics, cpu_params, cpu_opt = _train_run(
            cfg, params, batches, "cpu", make_opt)
        torch.cuda.synchronize()
        _build.reset_launches()
        card_metrics, card_params, card_opt = _train_run(
            cfg, params, batches, "cuda", make_opt)
        counts = {k: _build.launches[k] for k in kernels}
        d_loss = max(abs(a[0] - b[0])
                     for a, b in zip(cpu_metrics, card_metrics))
        d_norm = max(abs(a[1] - b[1]) / a[1]
                     for a, b in zip(cpu_metrics, card_metrics))
        d_params = max(max_err(a, b) for a, b in zip(
            _leaves(cpu_params), _leaves(card_params)))
        extra = ""
        params_ok = d_params <= TRAIN_TOL["params"]
        if label == "QuantizedMoments":
            # grads differ in their last bits (cuBLAS and flash against
            # the CPU's sums), which can move a payload by one count and
            # then that element's update by a good part of lr: the params
            # are held by their whole update, per leaf
            pairs = [(cpu_opt.state[a][k], card_opt.state[b][k].cpu())
                     for a, b in zip(cpu_opt.param_groups[0]["params"],
                                     card_opt.param_groups[0]["params"])
                     for k in ("mu_q", "nu_q")]
            off = sum(differing(a, b) for a, b in pairs)
            total = sum(a.numel() for a, _ in pairs)
            worst = max(int((a.int() - b.int()).abs().max()) for a, b in pairs)
            rel = max(float(torch.linalg.vector_norm(b - a) /
                            torch.linalg.vector_norm(a - p0))
                      for a, b, p0 in zip(_leaves(cpu_params),
                                          _leaves(card_params),
                                          _leaves(params)))
            params_ok = (rel <= INT8_TRAIN_TOL["update_rel"] and worst <= 1
                         and off <= INT8_TRAIN_TOL["payload_frac"] * total)
            extra = (f" int8 payloads: {off} of {total} differ, by at most "
                     f"{worst} count; worst leaf |d update| / |update| "
                     f"{rel:.3g} (tol {INT8_TRAIN_TOL});")
        ok = (d_loss <= TRAIN_TOL["loss"]
              and d_norm <= TRAIN_TOL["grad_norm"] and params_ok
              and all(v > 0 for v in counts.values()))
        log(f"[parity] tiny fp32 head_dim={cfg.head_dim} training, 3 {label} "
            f"steps: cpu losses "
            f"{[round(m[0], 6) for m in cpu_metrics]} card "
            f"{[round(m[0], 6) for m in card_metrics]}; max |d loss|="
            f"{d_loss:.3g} max rel d grad_norm={d_norm:.3g} max |d param|="
            f"{d_params:.3g} (tol {TRAIN_TOL});{extra} card launches "
            f"{counts} {'ok' if ok else 'FAIL'}")
        require(ok, f"tiny fp32 {label} training: card and CPU disagree")
    bf16_train_parity(params, batches)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def _step0_grads(cfg, params, tokens, device, attention_fn=None):
    """{leaf name: grad on the CPU} of one loss on ``device`` from a copy
    of ``params``."""
    from dlrover_tpu_torch.models import llama

    p = _clone_to(params, device)
    leaves = _leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    kw = {} if attention_fn is None else {"attention_fn": attention_fn}
    loss = llama.loss_fn(p, {"tokens": torch.from_numpy(tokens).to(device)},
                         cfg, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return {n: g.detach().float().cpu()
            for n, g in zip(_leaf_names(p), grads)}


def bf16_train_parity(params, batches):
    """``LlamaConfig.tiny()`` in bf16 compute (fp32 masters) on the card
    and on the CPU from the same params: both round activations, p and
    ds to bf16 at the same points from fp32 values that differ in their
    last bits, so AGD's sign-like step would turn those bits into whole
    steps of lr in the params after a few steps.  The two are held by
    step 0's grads per leaf (|g_card - g_cpu| / |g_cpu|, L2), whose limit
    sits between the sound reading and that of the card with dq zeroed
    (wq's grad 0), and over 3 AGD steps by loss and grad norm."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.optimizers import AGD

    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16)
    make_opt = lambda ps: AGD(ps, lr=1e-3)  # noqa: E731
    g_cpu = _step0_grads(cfg, params, batches[0], "cpu")
    g_card = _step0_grads(cfg, params, batches[0], "cuda")
    # q's value unchanged, its gradient (and so wq's) zero
    g_bad = _step0_grads(cfg, params, batches[0], "cuda",
                         attention_fn=lambda q, k, v, **kw:
                         llama.flash_attention(q.detach() + 0 * q, k, v,
                                               **kw))

    def rel(g):
        return {n: float(torch.linalg.vector_norm(g[n] - r)
                         / torch.linalg.vector_norm(r))
                for n, r in g_cpu.items()}

    sound, bad = rel(g_card), rel(g_bad)
    worst = max(sound, key=sound.get)
    cpu_m, _, _ = _train_run(cfg, params, batches, "cpu", make_opt)
    torch.cuda.synchronize()
    _build.reset_launches()
    card_m, _, _ = _train_run(cfg, params, batches, "cuda", make_opt)
    counts = {k: _build.launches[k] for k in TRAIN_KERNELS}
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(cpu_m, card_m))
    d_norm = max(abs(a[1] - b[1]) / a[1] for a, b in zip(cpu_m, card_m))
    ok = (sound[worst] <= BF16_TRAIN_TOL["grads"] < bad["layers.wq"]
          and d_loss <= BF16_TRAIN_TOL["loss"]
          and d_norm <= BF16_TRAIN_TOL["grad_norm"]
          and all(v > 0 for v in counts.values()))
    log(f"[parity] tiny bf16 head_dim={cfg.head_dim} training: step 0 "
        f"grads, worst leaf |d g| / |g| {sound[worst]:.3g} ({worst}), with "
        f"dq zeroed: wq {bad['layers.wq']:.3g}; 3 AGD steps: cpu losses "
        f"{[round(m[0], 6) for m in cpu_m]} card "
        f"{[round(m[0], 6) for m in card_m]}; max |d loss|={d_loss:.3g} "
        f"max rel d grad_norm={d_norm:.3g} (tol {BF16_TRAIN_TOL}); card "
        f"launches {counts} {'ok' if ok else 'FAIL'}")
    require(ok, "tiny bf16 AGD training: card and CPU disagree, or the "
            "check cannot see dq zeroed")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def flash_pairs(b, h, s):
    """(query, key) pairs a causal pass visits, for this run's shape."""
    return b * h * s * (s + 1) // 2


def flash_bound_ms(kind, q, k):
    """Bytes: each input once, each output once.  Operations: 2 * D per
    visible (query, key) pair and product: forward 2 products (q k^T,
    p v), dK/dV 4 (s, dp, dv, dk), dQ 3 (s, dp, dq)."""
    b, s, h, d = q.shape
    item = q.element_size()
    qb, kb, row = q.numel() * item, k.numel() * item, b * h * s * 4
    products = {"fwd": 2, "dkv": 4, "dq": 3}[kind]
    nbytes = {
        "fwd": qb + 2 * kb + qb + row,
        "dkv": 2 * qb + 2 * kb + 2 * row + 2 * kb,
        "dq": 2 * qb + 2 * kb + 2 * row + qb,
    }[kind]
    return bound(nbytes, products * 2 * d * flash_pairs(b, h, s), q.dtype)


def events_ms(fn, iters: int = 10) -> float:
    """Device time of one ``fn()`` from CUDA events around ``iters``
    eager calls (for a library backward that a graph cannot capture).
    The calls queue behind a spinning kernel (~0.1 s) so that the card
    runs them back to back, however slowly the host launches them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_queue_depth(n: int = 8192) -> int:
    """How many kernel launches the host can queue ahead of the card:
    with the card held busy by a spinning kernel (about 1 s), the index
    of the first of ``n`` one-element adds whose launch keeps the host
    waiting more than 5 ms (``n`` if none does)."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    depth = n
    for i in range(n):
        t = time.perf_counter()
        x.add_(1.0)
        if time.perf_counter() - t > 5e-3:
            depth = i
            break
    torch.cuda.synchronize()
    return depth


def rms_bwd_row(fused, cap, launches):
    """The backward's row on its captured input (a fused norm's, with
    the residual gradient): the rerun must equal the training path's dx
    and dw, the check of ``check_rms_bwd`` (planted faults, three runs bit
    for bit) holds, and the library yardstick is ``F.rms_norm`` forward
    plus ``autograd.grad`` (forward + backward; with a bf16 weight, since
    PyTorch runs bf16 x with an fp32 weight unfused)."""
    import torch.nn.functional as F

    h, w, rstd, g, g_res = cap.args
    d = h.shape[-1]
    args = (h.reshape(-1, d), w, rstd.reshape(-1, 1), g.reshape(-1, d),
            g_res.reshape(-1, d))
    dx, dw = fused.rms_norm_bwd(*args)
    require(torch.equal(dx.reshape(cap.out[0].shape), cap.out[0])
            and torch.equal(dw, cap.out[1]),
            "rms_norm_bwd rerun differs from the training path's output")
    dx_ref, dw_ref = fused.rms_norm_bwd_plain(*args)
    lim = dw_limit(dw_ref)
    dxr = dx_readings(dx, dx_ref, dropped_dot_ref(*args))
    e_dx, e_dw = dxr[0], max_err(dw, dw_ref) / lim
    err = max_err(dx, dx_ref)
    e_bad = max_err(dw, dropped_part_ref(fused, *args[:4])) / lim
    same = bitwise_repeat(lambda: fused.rms_norm_bwd(*args))
    log(f"[captured] rms_norm_bwd training {tuple(h.shape)} {h.dtype} x, "
        f"{w.dtype} weight, with g_res: dx err/limit={e_dx:.3g} differing="
        f"{dxr[1]:.2e}, last vector dropped from dot: err/limit="
        f"{dxr[2]:.3g} differing={dxr[3]:.2e}; dw err/limit={e_dw:.3g}, "
        f"one CTA's sum dropped dw={e_bad:.3g} (dw limit {lim:.3g}); 3 "
        f"runs equal bit for bit: {same}")
    require(dx_ok(h.dtype, *dxr) and e_dw <= 1.0 < e_bad and same,
            "rms_norm_bwd on the training input, or its check cannot see "
            "a planted fault")
    xl = args[0].detach().clone().requires_grad_(True)
    wl = w.detach().to(torch.bfloat16).requires_grad_(True)
    lib = events_ms(lambda: torch.autograd.grad(
        F.rms_norm(xl, (d,), wl, 1e-5), (xl, wl), args[3]))
    row = kernel_row(
        "rms_norm_bwd", "dlrover_tpu_torch/ops/csrc/rms_norm.cu",
        "dlrover_tpu/ops/fused.py:121", launches, err,
        "dx: one bf16 ulp of its row's largest |dx|; dw: dw_limit",
        lambda: fused.rms_norm_bwd(*args),
        lambda: fused.rms_norm_bwd_plain(*args), None,
        rms_bwd_bound_ms(args[0], w, True))
    row.update(library_ms=lib, library_note=(
        "F.rms_norm forward + autograd.grad, bf16 weight, no g_res"),
        note="_rms_bwd is jnp in the reference: no Pallas kernel",
        dx_err_over_limit=e_dx, dx_differing=dxr[1],
        dropped_dot_dx_differing=dxr[3], dw_err_over_limit=e_dw,
        dropped_part_dw_err_over_limit=e_bad)
    log_row(row)
    return row


def train_path(args):
    """Llama-2-7B width (dim 4096, 32 heads, MHA, mlp 11008, vocab
    32000) at ``--train-layers`` layers through ``auto_accelerate`` ->
    ``Trainer.train``: bf16 compute, fp32 masters, remat "full", fused
    CE in 512-row chunks, AGD(lr=3e-4), one fixed 4 x 2048 batch of
    random tokens, ``--train-steps`` steps.  Returns the kernel rows of
    the path (RMSNorm at the training shape, B2-B4)."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.parallel.train_step import param_leaves
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    cfg = llama.LlamaConfig.llama2_7b(n_layers=args.train_layers)
    L, steps = cfg.n_layers, args.train_steps
    batch, seq = 4, 2048
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)

    def init_fn(gen, dev):
        return llama.init_params(cfg, gen, dev, dtype=torch.float32)

    # the matmul settings a user of examples/llama_pretrain.py runs under
    # (PyTorch's defaults: bf16 GEMMs may reduce in bf16; TF32 is off)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        args.bf16_reduced_default)
    log(f"[train] matmul settings: allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        "allow_bf16_reduced_precision_reduction="
        f"{args.bf16_reduced_default} (PyTorch's defaults)")

    # step 0 with the dense plain attention, from the same init, and the
    # attention leaves' grads with flash and with flash whose dq is
    # zeroed (the planted fault)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_fn(gen, torch.device("cuda"))
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    names = ("wq", "wk", "wv")
    attn_leaves = [params["layers"][n] for n in names]
    tb = {"tokens": torch.from_numpy(tokens).cuda()}
    loss0 = llama.loss_fn(params, tb, cfg,
                          attention_fn=llama.dot_product_attention)
    grads = torch.autograd.grad(loss0, leaves)
    norm0 = float(torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads))))
    loss0 = float(loss0.detach())
    ids = [id(p) for p in leaves]
    dense = [grads[ids.index(id(p))] for p in attn_leaves]
    del grads

    def attn_grad_err(attention_fn):
        """{leaf: worst layer's |g - g_dense| / |g_dense|}."""
        loss = llama.loss_fn(params, tb, cfg, attention_fn=attention_fn)
        got = torch.autograd.grad(loss, attn_leaves, allow_unused=True,
                                  materialize_grads=True)
        return {n: float(max(
            torch.linalg.vector_norm((g - r).float()) / torch.linalg.
            vector_norm(r.float()) for g, r in zip(gl, rl)))
            for n, gl, rl in zip(names, got, dense)}

    sound_g = attn_grad_err(llama.flash_attention)
    fault_g = attn_grad_err(
        lambda q, k, v, **kw: llama.flash_attention(q.detach(), k, v, **kw))
    del params, leaves, attn_leaves, dense, tb
    torch.cuda.empty_cache()
    log(f"[train] step 0, attention leaves' grads, worst layer, flash "
        f"against dense: {sound_g}; with dq zeroed: {fault_g} (limit "
        f"{STEP0_TOL['attn_grads']})")
    require(max(sound_g.values()) <= STEP0_TOL["attn_grads"]
            < max(fault_g.values()),
            "step 0: attention grads differ from the dense attention, or "
            "the check cannot see dq zeroed")
    log(f"[train] launch queue: the host waits after "
        f"{launch_queue_depth()} launches queued ahead of a busy card")

    opt_events = []
    result = auto_accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        optimizer=timed_optimizer(lambda ps: AGD(ps, lr=3e-4), opt_events),
        init_params_fn=init_fn,
        device="cuda",
    )
    prof = result.profile
    log(f"[train] Llama-2-7B width, {L} layers, {prof.num_params / 1e9:.3f}B "
        f"params (fp32 masters {prof.param_bytes / 2**30:.2f} GiB, AGD state "
        f"{prof.optimizer_bytes / 2**30:.2f} GiB), bf16 compute, remat "
        f"{cfg.remat}, fused CE chunk {cfg.ce_chunk_rows}, batch {batch} x "
        f"{seq}, {steps} steps, strategy {result.strategy.describe()}")

    def data_iter():
        while True:
            yield {"tokens": tokens}

    # the host time of each train_step call: with the launch queue full
    # it returns only when the card is near the end of the step
    fns = result.fns
    inner, host_s = fns.train_step, []

    def timed_step(state, b):
        t = time.perf_counter()
        out = inner(state, b)
        host_s.append(time.perf_counter() - t)
        return out

    fns.train_step = timed_step
    trainer = Trainer(result, TrainingArgs(max_steps=steps, log_interval=0),
                      data_iter)
    # the first call (layer 0 of step 1's forward) of each
    attn_cap = Capture(llama, "flash_attention", score=lambda: 0)
    rms_cap = Capture(llama, "rms_norm", score=lambda: 0)
    add_cap = Capture(llama, "add_rms_norm", score=lambda: 0)
    # the backward of a fused norm (with the residual gradient)
    bwd_cap = Capture(fused, "rms_norm_bwd", score=lambda: 0,
                      when=lambda *a: len(a) > 4 and a[4] is not None)
    caps = (attn_cap, rms_cap, add_cap, bwd_cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        summary = trainer.train()
    finally:
        for c in caps:
            c.restore()
        fns.train_step = inner
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: _build.launches[k] for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    for r, h in zip(hist, host_s):
        log(f"[train] step {r['step']} loss={r['loss']:.6f} grad_norm="
            f"{r['grad_norm']:.6f} step_ms={1e3 * r['step_time_s']:.3f} "
            f"(card clock, end to end) host_ms_in_train_step={1e3 * h:.3f}")
    # steps 2..N as one window: from step 1's end to step N's end on the
    # card's clock (the sum of their step times)
    window_s = sum(r["step_time_s"] for r in hist[1:])
    step_s = window_s / (steps - 1)
    tokens_per_step = batch * seq
    flops = model_flops(cfg, prof, batch, seq)
    mfu = flops / step_s / PEAK_OPS[torch.bfloat16]
    opt_ms = [s.elapsed_time(e) for s, e in opt_events]
    per_step = {k: v / steps for k, v in counts.items()}
    expect = {"rms_norm": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
              "flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L}
    log(f"[train] final_step={summary['final_step']} wall_s={wall:.3f} "
        f"(host, steps 1-{steps} + sync) sum_of_step_ms="
        f"{1e3 * sum(r['step_time_s'] for r in hist):.3f} "
        f"step_ms_window(2-{steps})={1e3 * step_s:.3f} tokens_per_s="
        f"{tokens_per_step / step_s:.1f} model_tflop_per_step="
        f"{flops / 1e12:.3f} mfu={mfu:.4f} (of 989 TFLOP/s bf16) "
        f"max_memory_allocated_GiB={peak / 2**30:.2f} AGD optimizer_ms "
        f"(card clock) {[round(o, 3) for o in opt_ms]} "
        f"launches_per_step={per_step} expected={expect}")
    d_loss = abs(hist[0]["loss"] - loss0)
    d_norm = abs(hist[0]["grad_norm"] - norm0) / norm0
    log(f"[train] step 0 with the plain attention on the card: loss="
        f"{loss0:.6f} grad_norm={norm0:.6f}; |d loss|={d_loss:.3g} rel d "
        f"grad_norm={d_norm:.3g} (tol {STEP0_TOL})")
    require(all(np.isfinite(losses)), "a training loss is not finite")
    require(losses[-1] < losses[0], "training loss did not fall")
    require(per_step == expect, f"launches per step {per_step} != {expect}")
    require(d_loss <= STEP0_TOL["loss"] and d_norm <= STEP0_TOL["grad_norm"],
            "step 0 differs from the plain attention")
    if args.profile:
        state = trainer.state
        batch_dev = {"tokens": torch.from_numpy(tokens).cuda()}

        def one_step():
            result.fns.train_step(state, batch_dev)
            return 1

        profile_step(one_step, f"one training step, {L} layers")
    # the timed optimizer's step refers back to it: collect the cycle
    del trainer, result, fns
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # the training path's RMSNorm: bf16 x with the fp32 master weight,
    # layer 0's attention norm and its MLP norm (the add of wo's output)
    rows = rms_rows(fused, rms_cap, add_cap, counts["rms_norm"], "_train")
    rows.append(rms_bwd_row(fused, bwd_cap, counts["rms_norm_bwd"]))
    del rms_cap, add_cap, bwd_cap
    torch.cuda.empty_cache()

    q, k, v = attn_cap.args[:3]
    require(tuple(q.shape) == (batch, seq, cfg.n_heads, cfg.head_dim)
            and q.dtype == torch.bfloat16, "captured flash input shape")
    scale = cfg.head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dout = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    o, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
    require(torch.equal(o, attn_cap.out),
            "flash_fwd rerun differs from the training path's output")
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = fa.attention_delta(o_ref, dout)
    bargs = (q, k, v, dout, lse_ref, delta, None, True, scale)
    dk, dv = fa.flash_bwd_dkv_kernel(*bargs)
    dq = fa.flash_bwd_dq_kernel(*bargs)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*bargs)
    torch.cuda.synchronize()
    got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    ref = dict(o=o_ref, lse=lse_ref, dq=fa.flash_bwd_dq_plain(*bargs),
               dk=dk_ref, dv=dv_ref)
    sound = flash_errs(got, ref, q.dtype)
    fault = flash_errs(got, faulted_refs(fa, *bargs, ref), q.dtype)
    abs_err = {kern: max(max_err(got[n], ref[n]) for n in outs)
               for kern, outs in FLASH_OUT.items()}
    log(f"[captured] flash layer 0 q={tuple(q.shape)} bf16 causal "
        f"err/limit {sound} dropped-tile err/limit {fault} max_abs_err "
        f"{abs_err} limits={FLASH_TOL[q.dtype]}")
    for kern, outs in FLASH_OUT.items():
        require(max(sound[n] for n in outs) <= 1.0
                < max(fault[n] for n in outs),
                f"{kern} on the captured input")
    same = {"flash_fwd": bitwise_repeat(
                lambda: fa.flash_fwd_kernel(q, k, v, True, scale)),
            "flash_bwd_dkv": bitwise_repeat(
                lambda: fa.flash_bwd_dkv_kernel(*bargs)),
            "flash_bwd_dq": bitwise_repeat(
                lambda: fa.flash_bwd_dq_kernel(*bargs))}
    log(f"[check] flash on the captured input, 3 runs of each kernel "
        f"equal bit for bit: {same}")
    require(all(same.values()), "a flash kernel is not deterministic on "
            "the captured input")
    del got, ref, o_ref, lse_ref, dk_ref, dv_ref, o, lse, dk, dv, dq
    torch.cuda.empty_cache()

    # the library yardstick: SDPA (never called by the port) on
    # [B, H, S, D] copies; its backward computes dq, dk and dv in one call
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dout_t = dout.transpose(1, 2).contiguous()
    with torch.no_grad():
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_bwd_ms = events_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dout_t, retain_graph=True))
    del out_t, qt, kt, vt, dout_t
    torch.cuda.empty_cache()
    log(f"[time] SDPA causal forward {sdpa_fwd_ms:.4f} ms, backward (dq, "
        f"dk, dv in one call, eager, events) {sdpa_bwd_ms:.4f} ms")

    csrc = "dlrover_tpu_torch/ops/csrc/"
    report = build_report(kernel_smem())
    for name, replaces, kind, fn, plain, lib in (
        ("flash_fwd", "dlrover_tpu/ops/flash_attention.py:42", "fwd",
         lambda: fa.flash_fwd_kernel(q, k, v, True, scale),
         lambda: fa.flash_fwd_plain(q, k, v, True, scale), sdpa_fwd_ms),
        ("flash_bwd_dkv", "dlrover_tpu/ops/flash_attention.py:275", "dkv",
         lambda: fa.flash_bwd_dkv_kernel(*bargs),
         lambda: fa.flash_bwd_dkv_plain(*bargs), sdpa_bwd_ms),
        ("flash_bwd_dq", "dlrover_tpu/ops/flash_attention.py:340", "dq",
         lambda: fa.flash_bwd_dq_kernel(*bargs),
         lambda: fa.flash_bwd_dq_plain(*bargs), None),
    ):
        outs = FLASH_OUT[name]
        src = csrc + ("flash_attention.cu" if kind == "fwd"
                      else "flash_attention_bwd.cu")
        row = kernel_row(name, src, replaces, counts[name], abs_err[name],
                         FLASH_TOL[q.dtype], fn, plain, None,
                         flash_bound_ms(kind, q, k))
        row["library_ms"] = lib
        row["err_over_limit"] = max(sound[n] for n in outs)
        row["dropped_tile_err_over_limit"] = max(fault[n] for n in outs)
        if name == "flash_bwd_dkv":
            row["library_note"] = ("SDPA backward, dq+dk+dv in one call: "
                                   "compare with flash_bwd_dkv + "
                                   "flash_bwd_dq")
        if name in report:
            row["build"] = report[name]
        log(f"[time] {name} captured layer 0 ms={row['ms']:.4f} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}) bound/ms="
            f"{row['bound_share']:.3f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={lib if lib is None else round(lib, 4)} launches="
            f"{row['launches']} build={report.get(name, '-')}")
        rows.append(row)
    return rows


# ---------------------------------------------------------- int8 Adam


B1, B2, EPS = 0.9, 0.999, 1e-8
INT8_SIZES = (0, 1, 300, 1024, 8 * 1024, 9 * 1024 + 17, 131072)
# fp32 operations per element, for the operation bound: quantize (abs,
# max, divide, round, clamp), dequantize (multiply), the Adam update (2
# dequantizing multiplies, 9 for the moments, 5 for the update, 2 square
# roots, 2 abs-max and 2 x 3 to requantize)
INT8_OPS = {"quantize": 5, "dequantize": 1, "int8_adam": 28}


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two fp32
    tensors of one sign pattern (their bit patterns as integers)."""
    if a.numel() == 0:
        return 0
    d = a.contiguous().view(torch.int32).long() - b.contiguous().view(
        torch.int32).long()
    return int(d.abs().max())


def int8_input(n, gen):
    """``n`` fp32 values; where three blocks fit, block 0 is all zero
    (scale at the 1e-12 floor), block 1 holds one value 1e4 times the
    rest (the case for storing sqrt(nu)), block 2 is the half-way block
    (absmax 127, so scale 1.0, and values at .5 that round half to
    even)."""
    x = torch.randn(n, device="cuda", generator=gen)
    if n >= 3 * 1024:
        x[:1024] = 0.0
        x[1024:2048] *= 1e-4
        x[1024 + 7] = 1.0
        half = torch.tensor([127.0, 0.5, 2.5, 126.5, -0.5, -2.5, -126.5, 1.5],
                            device="cuda")
        x[2048:3072] = torch.clamp(50.0 * x[2048:3072], -126.0, 126.0)
        x[2048:2056] = half
    return x


def stale_block(new, old, blk):
    """The planted fault: ``new`` (a ``[n_blocks, ...]`` output of the
    plain version) with block ``blk`` left at its value in ``old``, as
    when a kernel skips one block."""
    bad = new.clone()
    bad[blk] = old[blk]
    return bad


def int8_case(q, n, step, gen):
    """B7, B8 and B9 against their plain versions on one input of ``n``
    elements.  Each must agree (payloads, scales and dequantized values
    bit for bit, B9's update within 1 ulp) and must not agree with the
    plain version whose last block was left at its old value.  Returns
    {kernel: (reading, stale-block reading)}: differing elements, or
    ulps for the update."""
    x = int8_input(n, gen)
    x_old = 0.5 * int8_input(n, gen)
    nb = q.padded_blocks(n)
    kw = dict(lr=1e-3, b1=B1, b2=B2, eps=EPS)
    res = {}
    # B7
    qk, sk, meta = q.quantize_blockwise(x)
    torch.cuda.synchronize()
    if n == 0:
        require(qk.shape == (0, 128) and sk.shape == (0, 1)
                and meta == ((0,), 0), "quantize of n == 0")
        empty = q.dequantize_blockwise(qk, sk, meta)
        upd = q.fused_int8_adam_update(x, qk, sk, qk, sk, meta, 0.1, 0.1,
                                       **kw)
        require(empty.shape == (0,) and upd[0].shape == (0,),
                "n == 0 outputs")
        return {"quantize": (0, None), "dequantize": (0, None),
                "int8_adam": (0, None), "int8_adam_update_ulps": (0, None)}
    blk = (n - 1) // q.BLOCK  # the last block that holds data
    qp, sp = q.quantize_plain(q._pad_blocks(x, nb))
    qo, so = q.quantize_plain(q._pad_blocks(x_old, nb))
    qk2 = qk.view(nb, q.BLOCK)
    sound = differing(qk2, qp) + differing(sk, sp)
    fault = differing(qk2, stale_block(qp, qo, blk)) + differing(
        sk, stale_block(sp, so, blk))
    res["quantize"] = (sound, fault)
    # B8 on the plain payload
    xk = q.dequantize_blockwise(qp.view(-1, 128), sp, meta)
    torch.cuda.synchronize()
    xp = q.dequantize_plain(qp, sp).view(-1)[:n]
    xo = q.dequantize_plain(qo, so).view(-1)
    bad = xp.clone()
    lo = blk * q.BLOCK
    bad[lo:] = xo[lo:n]
    res["dequantize"] = (differing(xk, xp), differing(xk, bad))
    # B9: g = x, moments from other values (non-zero state)
    mu0 = 0.1 * torch.randn(n, device="cuda", generator=gen)
    nu0 = 0.01 * torch.randn(n, device="cuda", generator=gen).abs()
    mq, ms, _ = q.quantize_blockwise(mu0)
    nq, ns, _ = q.quantize_blockwise(nu0.sqrt())
    bc1, bc2 = q.bias_corrections(B1, B2, step)
    out_k = q.fused_int8_adam_update(x, mq, ms, nq, ns, meta, bc1, bc2, **kw)
    # the optimizer's form: update over the grad, moments in place
    g2 = x.clone()
    state = [t.clone() for t in (mq, ms, nq, ns)]
    out_i = q.fused_int8_adam_update(g2, *state, meta, bc1, bc2, out=g2,
                                     inplace=True, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(out_k, out_i)),
            f"int8_adam n={n}: in place differs from out of place")
    upd_p, *new_p = q.fused_adam_plain(
        q._pad_blocks(x, nb), mq.view(nb, -1), ms, nq.view(nb, -1), ns, bc1,
        bc2, **kw)
    new_k = [out_k[1].view(nb, -1), out_k[2], out_k[3].view(nb, -1),
             out_k[4]]
    old = [mq.view(nb, -1), ms, nq.view(nb, -1), ns]
    sound = sum(differing(a, b) for a, b in zip(new_k, new_p))
    fault = sum(differing(a, stale_block(b, o, blk))
                for a, b, o in zip(new_k, new_p, old))
    u = ulps(out_k[0].view(-1), upd_p.view(-1)[:n])
    res["int8_adam"] = (sound, fault)
    res["int8_adam_update_ulps"] = (u, None)
    return res


def int8_optimizer_check(q, QuantizedMoments, wd, gen):
    """``QuantizedMoments`` on the card (B9 kernels) against the same
    three steps written with the plain version on the card, over leaves
    of a stacked layer, a norm and a ragged size: int8 state bit for bit
    after steps 1 and 3, params within 1 ulp."""
    shapes = ((3, 1024, 1000), (32, 4096), (9 * 1024 + 17,))
    lr = 1e-3
    leaves = [torch.randn(s, device="cuda", generator=gen).requires_grad_()
              for s in shapes]
    plain = [p.detach().clone() for p in leaves]
    grads = [[torch.randn(s, device="cuda", generator=gen) for s in shapes]
             for _ in range(3)]
    opt = QuantizedMoments(leaves, lr=lr, weight_decay=wd)
    opt.init_state()
    states = [[opt.state[p][k].clone() for k in ("mu_q", "mu_scales",
                                                  "nu_q", "nu_scales")]
              for p in leaves]
    worst = {"state_differing": 0, "param_ulps": 0}
    for step, gs in enumerate(grads, 1):
        for p, g in zip(leaves, gs):
            p.grad = g.clone()
        opt.step()
        bc1, bc2 = q.bias_corrections(B1, B2, step)
        for p, g, st in zip(plain, gs, states):
            n, nb = p.numel(), q.padded_blocks(p.numel())
            upd, *new = q.fused_adam_plain(
                q._pad_blocks(g.reshape(-1), nb), st[0].view(nb, -1), st[1],
                st[2].view(nb, -1), st[3], bc1, bc2, lr=lr, b1=B1, b2=B2,
                eps=EPS)
            upd = upd.view(-1)[:n].view(p.shape)
            if wd:
                upd.sub_(p, alpha=lr * wd)
            p.add_(upd)
            st[:] = [new[0].view(-1, 128), new[1], new[2].view(-1, 128),
                     new[3]]
        torch.cuda.synchronize()
        if step in (1, 3):
            for p, pp, st in zip(leaves, plain, states):
                got = [opt.state[p][k] for k in ("mu_q", "mu_scales", "nu_q",
                                                 "nu_scales")]
                worst["state_differing"] = max(
                    worst["state_differing"],
                    sum(differing(a, b) for a, b in zip(got, st)))
                worst["param_ulps"] = max(worst["param_ulps"],
                                          ulps(p.detach(), pp))
    ok = worst["state_differing"] == 0 and worst["param_ulps"] <= 1
    log(f"[check] QuantizedMoments weight_decay={wd}, 3 steps, card "
        f"kernels against the plain version on the card: {worst} (need "
        f"0 and <= 1) {'ok' if ok else 'FAIL'}")
    require(ok, f"QuantizedMoments wd={wd}: kernel and plain steps differ")


def int8_checks():
    """B7-B9 against their plain versions on the card over
    ``INT8_SIZES`` (the all-zero, one-spike and half-way blocks where
    three blocks fit), B9 at steps 1 and 3, each check also shown to
    reject the plain version with one block left stale; then the
    optimizer around B9 with weight decay 0 and 0.1."""
    from dlrover_tpu_torch.ops import quantization as q
    from dlrover_tpu_torch.optimizers import QuantizedMoments

    gen = torch.Generator(device="cuda").manual_seed(2)
    for n in INT8_SIZES:
        for step in (1, 3):
            res = int8_case(q, n, step, gen)
            ok = all(s == 0 for k, (s, _) in res.items()
                     if k != "int8_adam_update_ulps")
            ok = ok and res["int8_adam_update_ulps"][0] <= 1
            ok = ok and (n == 0 or all(
                f > 0 for k, (_, f) in res.items() if f is not None))
            log(f"[check] int8 n={n} step={step} (differing elements, "
                f"update in ulps; kernel against plain | against plain with "
                f"a stale block): "
                + " ".join(f"{k}={s}|{'-' if f is None else f}"
                           for k, (s, f) in res.items())
                + f" {'ok' if ok else 'FAIL'}")
            require(ok, f"int8 kernels n={n} step={step}")
    for wd in (0.0, 0.1):
        int8_optimizer_check(q, QuantizedMoments, wd, gen)


def timed_optimizer(make, events, before_step=None):
    """``make``'s optimizer with its ``step`` bracketed by CUDA events
    (appended to ``events``), so the optimizer's share of each step is
    read on the card's clock; ``before_step(opt)`` runs first when
    given."""

    def build(ps):
        opt = make(ps)
        inner = opt.step

        def step(*a, **kw):
            if before_step is not None:
                before_step(opt)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **kw)
            end.record()
            events.append((start, end))
            return out

        opt.step = step
        return opt

    return build


def model_flops(cfg, prof, batch, seq):
    """6 N tokens (N: parameters in matmuls, all but the embedding table
    and the norms) plus 6 x 2 x D per visible causal (query, key) pair
    and layer; remat not counted."""
    L = cfg.n_layers
    n_matmul = prof.num_params - cfg.vocab_size * cfg.dim - cfg.dim * (
        2 * L + 1)
    attn = 6 * 2 * cfg.head_dim * flash_pairs(batch, cfg.n_heads, seq) * L
    return 6 * n_matmul * batch * seq + attn


def int8_bound_ms(kind, n):
    """Bytes each input once and each output once over the card's
    memory rate, or ``INT8_OPS`` fp32 operations per element."""
    nb = -(-n // 1024)  # blocks that hold data
    padded = 1024 * nb
    nbytes = {
        "quantize": 4 * n + padded + 4 * nb,
        "dequantize": padded + 4 * nb + 4 * n,
        "int8_adam": 4 * n + 2 * padded + 8 * nb + 4 * n + 2 * padded
        + 8 * nb,
    }[kind]
    return bound(nbytes, INT8_OPS[kind] * n, torch.float32)


INT8_KERNELS = ("quantize", "dequantize", "int8_adam")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def int8_path(args):
    """Llama-2-7B (dim 4096, 32 heads, MHA, mlp 11008, vocab 32000) at
    ``--int8-layers`` layers (default: full depth) through
    ``auto_accelerate`` -> ``Trainer.train`` with
    ``QuantizedMoments(lr=3e-4, weight_decay=0.1)``: fp32 masters, bf16
    compute, remat "full", fused CE in 512-row chunks, one fixed 4 x 2048
    batch, ``--train-steps`` steps.  The largest leaf's grad and moments
    of the last step are captured; B7-B9 are held against their plain
    versions and timed on them.  Returns their kernel rows."""
    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import quantization as q
    from dlrover_tpu_torch.optimizers import (
        QuantizedMoments,
        dequantize_qtensor,
    )
    from dlrover_tpu_torch.parallel.train_step import param_leaves
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[int8] at the leg's start memory_allocated_GiB="
        f"{torch.cuda.memory_allocated() / 2**30:.3f} memory_reserved_GiB="
        f"{torch.cuda.memory_reserved() / 2**30:.3f}")
    cfg = llama.LlamaConfig.llama2_7b(n_layers=args.int8_layers)
    L, steps = cfg.n_layers, args.train_steps
    batch, seq = 4, 2048
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        args.bf16_reduced_default)
    events, captured = [], {}

    def capture(opt):
        # the last step's largest leaf: its grad and its moments before
        # the update (copies on the card, ~8 GiB at full depth)
        if len(events) != steps - 1:
            return
        p = max((p for g in opt.param_groups for p in g["params"]),
                key=lambda t: t.numel())
        st = opt.state[p]
        captured.update(
            shape=tuple(p.shape), grad=p.grad.detach().clone(),
            state=[st[k].clone() for k in ("mu_q", "mu_scales", "nu_q",
                                            "nu_scales")],
            step=opt.param_groups[0]["step"] + 1)

    make = timed_optimizer(
        lambda ps: QuantizedMoments(ps, lr=3e-4, weight_decay=0.1), events,
        capture)
    result = auto_accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        optimizer=make,
        init_params_fn=lambda gen, dev: llama.init_params(
            cfg, gen, dev, dtype=torch.float32),
        device="cuda",
    )
    prof = result.profile
    log(f"[int8] Llama-2-7B, {L} layers, {prof.num_params / 1e9:.3f}B params "
        f"(fp32 masters {prof.param_bytes / 2**30:.2f} GiB, int8 moments "
        f"with scales {prof.optimizer_bytes / 2**30:.2f} GiB, fp32 grads "
        f"{prof.param_bytes / 2**30:.2f} GiB), bf16 compute, remat "
        f"{cfg.remat}, fused CE chunk {cfg.ce_chunk_rows}, batch {batch} x "
        f"{seq}, {steps} steps, QuantizedMoments(lr=3e-4, weight_decay=0.1)")

    def data_iter():
        while True:
            yield {"tokens": tokens}

    trainer = Trainer(result, TrainingArgs(max_steps=steps, log_interval=0),
                      data_iter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: _build.launches[k] for k in TRAIN_KERNELS + INT8_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    # the caching allocator frees its cached blocks and retries (a device
    # sync) when an allocation does not fit
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    opt_ms = [s.elapsed_time(e) for s, e in events]
    for r, o in zip(hist, opt_ms):
        log(f"[int8] step {r['step']} loss={r['loss']:.6f} grad_norm="
            f"{r['grad_norm']:.6f} step_ms={1e3 * r['step_time_s']:.3f} "
            f"optimizer_ms={o:.3f} (card clock)")
    step_s = sum(r["step_time_s"] for r in hist[1:]) / (steps - 1)
    flops = model_flops(cfg, prof, batch, seq)
    mfu = flops / step_s / PEAK_OPS[torch.bfloat16]
    per_step = {k: counts[k] / steps for k in TRAIN_KERNELS + ("int8_adam",)}
    expect = {"rms_norm": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
              "flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
              "int8_adam": len(param_leaves(trainer.state["params"]))}
    log(f"[int8] final_step={summary['final_step']} wall_s={wall:.3f} "
        f"step_ms_window(2-{steps})={1e3 * step_s:.3f} tokens_per_s="
        f"{batch * seq / step_s:.1f} model_tflop_per_step={flops / 1e12:.3f} "
        f"mfu={mfu:.4f} (of 989 TFLOP/s bf16) max_memory_allocated_GiB="
        f"{peak / 2**30:.2f} max_memory_reserved_GiB="
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} "
        f"allocator_retries={retries} optimizer_ms_median="
        f"{statistics.median(opt_ms):.3f} launches_per_step={per_step} "
        f"expected={expect} quantize_launches={counts['quantize']} "
        f"(init: 2 per leaf) dequantize_launches={counts['dequantize']}")
    require(all(np.isfinite(losses)), "an int8 training loss is not finite")
    require(losses[-1] < losses[0], "int8 training loss did not fall")
    require(per_step == expect, f"launches per step {per_step} != {expect}")
    require(counts["quantize"] == 2 * expect["int8_adam"]
            and counts["dequantize"] == 0, "int8 init launches")
    if args.profile:
        batch_dev = {"tokens": torch.from_numpy(tokens).cuda()}

        def one_step():
            result.fns.train_step(trainer.state, batch_dev)
            return 1

        profile_step(one_step, f"one int8 training step, {L} layers")

    # inspection: every trained moment dequantized (B8), its norm
    opt = trainer.state["opt_state"]
    named = _named_leaves(trainer.state["params"])
    torch.cuda.synchronize()
    _build.reset_launches()
    norms = {name: tuple(
        float(torch.linalg.vector_norm(dequantize_qtensor(t)))
        for t in opt.moments(p)) for name, p in named}
    inspect_launches = _build.launches["dequantize"]
    log(f"[int8] trained moments, (|mu|, |sqrt(nu)|) per leaf: "
        + " ".join(f"{k}=({a:.4g}, {b:.4g})" for k, (a, b) in norms.items())
        + f"; dequantize launches {inspect_launches}")
    require(inspect_launches == 2 * len(named)
            and all(np.isfinite(v).all() and v[1] > 0
                    for v in norms.values()), "moment inspection")
    # the timed optimizer's step refers back to it: collect the cycle
    del trainer, result, opt, named, make
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # the captured leaf: B7 on its grad, B8 on its mu, B9 on both
    require(bool(captured), "the last step's leaf was not captured")
    g = captured["grad"].view(-1)
    n = g.numel()
    nb = q.padded_blocks(n)
    mq, ms, nq, ns = captured["state"]
    meta = (captured["shape"], n)
    bc1, bc2 = q.bias_corrections(B1, B2, captured["step"])
    kw = dict(lr=3e-4, b1=B1, b2=B2, eps=EPS)
    gb = q._pad_blocks(g, nb)
    rows = []
    log(f"[int8] captured leaf {captured['shape']} n={n} blocks={nb} step "
        f"{captured['step']}")

    def compare(got, ref):
        """(differing elements, max |got - ref|) over output pairs."""
        return (sum(differing(a, b) for a, b in zip(got, ref)),
                max(max_err(a, b) for a, b in zip(got, ref)))

    qk, sk, _ = q.quantize_blockwise(g)
    diff, err = compare((qk.view(nb, -1), sk), q.quantize_plain(gb))
    del qk, sk
    rows.append(("quantize", "dlrover_tpu/ops/quantization.py:35", diff, err,
                 lambda: q.quantize_blockwise(g),
                 lambda: q.quantize_plain(gb)))
    xk = q.dequantize_blockwise(mq, ms, meta)
    diff, err = compare((xk.view(-1),), (q.dequantize_plain(
        mq.view(nb, -1), ms).view(-1)[:n],))
    del xk
    rows.append(("dequantize", "dlrover_tpu/ops/quantization.py:49", diff,
                 err, lambda: q.dequantize_blockwise(mq, ms, meta),
                 lambda: q.dequantize_plain(mq.view(nb, -1), ms)))
    out_k = q.fused_int8_adam_update(g, mq, ms, nq, ns, meta, bc1, bc2, **kw)
    upd_p, *new_p = q.fused_adam_plain(gb, mq.view(nb, -1), ms,
                                       nq.view(nb, -1), ns, bc1, bc2, **kw)
    diff, _ = compare((out_k[1].view(nb, -1), out_k[2], out_k[3].view(nb, -1),
                       out_k[4]), new_p)
    err = max_err(out_k[0].view(-1), upd_p.view(-1)[:n])
    u = ulps(out_k[0].view(-1), upd_p.view(-1)[:n])
    del out_k, upd_p, new_p
    rows.append(("int8_adam", "dlrover_tpu/ops/quantization.py:118", diff,
                 err, lambda: q.fused_int8_adam_update(
                     g, mq, ms, nq, ns, meta, bc1, bc2, **kw),
                 lambda: q.fused_adam_plain(gb, mq.view(nb, -1), ms,
                                            nq.view(nb, -1), ns, bc1, bc2,
                                            **kw)))
    log(f"[captured] int8 leaf {captured['shape']}, kernel against plain: "
        + " ".join(f"{r[0]} differing={r[2]} max_abs_err={r[3]:.3g}"
                   for r in rows)
        + f"; int8_adam update {u} ulps (need 0 differing int8/scales/"
        "values and <= 1 ulp)")
    require(all(r[2] == 0 for r in rows) and u <= 1,
            "int8 kernels on the captured leaf")
    torch.cuda.empty_cache()
    launches = {"quantize": counts["quantize"],
                "dequantize": inspect_launches,
                "int8_adam": counts["int8_adam"]}
    out = []
    for name, replaces, diff, err, fn, plain in rows:
        # no single PyTorch call computes blockwise int8 quantization or
        # this Adam step (torch._fused_adam_ keeps fp32 moments)
        row = kernel_row(name, "dlrover_tpu_torch/ops/csrc/quantization.cu",
                         replaces, launches[name], err, 0.0, fn, plain, None,
                         int8_bound_ms(name, n))
        row["differing_elements"] = diff
        if name == "int8_adam":
            row["update_ulps"], row["update_tol_ulps"] = u, 1
        out.append(row)
        log(f"[time] {name} ms={row['ms']:.4f} plain_ms="
            f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) launches={row['launches']}")
    del captured, g, gb, mq, ms, nq, ns
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ checkpoint leg

CKPT_DEPTHS = (8, 4, 2)
CKPT_STEPS = 4  # run A; B stops after 2, C and D resume to 4


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _space(path) -> str:
    import shutil

    u = shutil.disk_usage(path)
    return (f"{path}: total {u.total / 1e9:.2f} GB, free "
            f"{u.free / 1e9:.2f} GB")


def _state_bytes(cfg, int8: bool) -> int:
    """Bytes of a snapshot of the train state: fp32 params and, with
    AGD, two fp32 moments; with int8 moments, per leaf two int8 payloads
    in 1024-element blocks (more than 8 blocks rounded up to a multiple
    of 8) and their fp32 scales."""
    from dlrover_tpu_torch.models import llama

    shapes = llama.init_params(cfg, device="meta", dtype=torch.float32)
    total = 8  # the two int32 step counts
    for p in _leaves(shapes):
        n = p.numel()
        total += 4 * n
        if int8:
            blocks = -(-n // 1024)
            if blocks > 8:
                blocks = -(-blocks // 8) * 8
            total += 2 * (blocks * 1024 + 4 * blocks)
        else:
            total += 8 * n
    return total


def pinned_rates(card: str):
    """The yardstick: a pinned 1 GiB buffer to and from the card (CUDA
    events, median of 5)."""
    n = 1 << 30
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, fn in (("d2h", lambda: host.copy_(dev, non_blocking=True)),
                     ("h2d", lambda: dev.copy_(host, non_blocking=True))):
        ts = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / 1e3)
        out[name] = n / 1e9 / statistics.median(ts)
    del dev, host
    log(f"[ckpt] {card} | pinned 1 GiB copy: card -> host "
        f"{out['d2h']:.3f} GB/s, host -> card {out['h2d']:.3f} GB/s "
        "(the yardstick of every transfer below)")
    return out


def _host_copy(state):
    from dlrover_tpu_torch.agent.ckpt_shm import _flatten_keyed

    return {k: (v.detach().cpu() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v)))
            for k, v in _flatten_keyed(state)}


def _differing_leaves(state, want):
    from dlrover_tpu_torch.agent.ckpt_shm import _flatten_keyed

    pairs = _flatten_keyed(state)
    if [k for k, _ in pairs] != list(want):
        return ["<key paths differ>"]
    bad = []
    for k, v in pairs:
        v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        w = want[k].to(v.device)
        if v.dtype != w.dtype or not torch.equal(v, w):
            bad.append(k)
        del w
    return bad


def _hist(trainer):
    return [(r["step"], r["loss"], r["grad_norm"]) for r in trainer.history]


def _io_reading(kind):
    """(bytes, GB/s) of the last checkpoint transfer of ``kind`` (the
    engine's and the saver's ``record_ckpt_io`` gauges)."""
    from dlrover_tpu_torch.observability.metrics import get_registry

    reg = get_registry()
    lab = {"kind": kind}
    return (reg.get("dlrover_tpu_ckpt_io_bytes", lab),
            reg.get("dlrover_tpu_ckpt_io_gbps", lab))


def ckpt_leg(label, cfg, make_opt, mode, root, tokens, card, rates,
             kernels, faults):
    """Runs A (uninterrupted), B (2 steps, snapshot every step, persist at
    2), C (a fresh ``Trainer`` restored from shm, to step 4) and D (shm
    unlinked, restored from the ``.drckpt``, to step 4) at ``cfg``;
    C's and D's losses, grad norms and every state leaf must equal A's
    bit for bit, and B's must equal A's first two.  With ``faults`` the
    two planted faults run between B and C.  Returns the readings."""
    import shutil

    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.models.convert import train_state_leaves
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
    from dlrover_tpu_torch.trainer.checkpoint.engine import CheckpointEngine

    def init_fn(gen, dev):
        return llama.init_params(cfg, gen, dev, dtype=torch.float32)

    result = auto_accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg), optimizer=make_opt,
        init_params_fn=init_fn, device="cuda")
    batch = {"tokens": tokens}

    def data_iter():
        while True:
            yield batch

    def run(max_steps, ckpt_dir=None):
        ck = {} if ckpt_dir is None else dict(
            checkpoint_dir=ckpt_dir, save_memory_interval=1,
            save_storage_interval=2, snapshot_mode=mode)
        trainer = Trainer(result, TrainingArgs(
            max_steps=max_steps, log_interval=0, **ck), data_iter)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0

    def free():
        # the caller has dropped its names: collect the cycles too
        gc.collect()
        torch.cuda.empty_cache()

    def report(name, trainer, wall):
        for r in trainer.history:
            log(f"[ckpt] {label} {name} step {r['step']} loss="
                f"{r['loss']!r} grad_norm={r['grad_norm']!r} step_ms="
                f"{1e3 * r['step_time_s']:.3f} (card clock)")
        for s in trainer.save_times:
            log(f"[ckpt] {card} | {label} {name} _maybe_checkpoint step "
                f"{s['step']} mode={s['mode']} storage={s['storage']} "
                f"saved={s['saved']} "
                f"host_ms={1e3 * s['host_s']:.3f}")
        eng = trainer.checkpoint_engine
        for kind, step, nb, dur in (eng.io_log if eng else ()):
            log(f"[ckpt] {card} | {label} {name} {kind} step {step}: "
                f"{nb / 1e9:.3f} GB in {dur:.3f} s = {nb / 1e9 / dur:.3f} "
                f"GB/s (pinned {'d2h' if kind == 'drain' else 'h2d'} "
                f"{rates['d2h' if kind == 'drain' else 'h2d']:.3f})")
        if eng is not None:
            log(f"[ckpt] {label} {name} skipped snapshots "
                f"{eng.skipped_snapshots}")
        log(f"[ckpt] {label} {name} wall_s={wall:.3f}")
        return {"steps": [r["step_time_s"] for r in trainer.history],
                "saves": trainer.save_times,
                "io": list(eng.io_log) if eng else []}

    out = {}
    _build.reset_launches()
    ta, wall = run(CKPT_STEPS)
    counts = {k: v for k, v in _build.launches.items() if v}
    out["A"] = report("A (uninterrupted)", ta, wall)
    hist_a = _hist(ta)
    want = _host_copy(ta.state)
    nbytes = sum(int(v.nbytes) for v in want.values())
    out["state_bytes"] = nbytes
    log(f"[ckpt] {label} state: {len(want)} leaves, {nbytes / 1e9:.3f} GB; "
        f"run A launches {counts}")
    require(all(counts.get(k, 0) > 0 for k in kernels),
            f"{label}: run A launched none of some of {kernels}")
    del ta
    free()

    d = os.path.join(root, label)
    d_disk = d + "_disk"
    factory = AsyncCheckpointSaver.start_async_saving_ckpt(
        install_signal_handlers=False)

    def drop_shm():
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        if saver is not None:
            saver.close(unlink=True)
        AsyncCheckpointSaver._instance = None

    try:
        tb, wall = run(2, d)
        out["B"] = report("B (2 steps)", tb, wall)
        out["prealloc"] = _io_reading("prealloc")
        out["persist_B"] = _io_reading("persist")
        log(f"[ckpt] {card} | {label} preallocation of 2 slots: "
            f"{out['prealloc'][0] / 1e9:.3f} GB at {out['prealloc'][1]:.3f} "
            f"GB/s; persist of step 2: {out['persist_B'][0] / 1e9:.3f} GB "
            f"at {out['persist_B'][1]:.3f} GB/s")
        require(_hist(tb) == hist_a[:2],
                f"{label}: two uninterrupted runs disagree over steps 1-2: "
                f"{_hist(tb)} vs {hist_a[:2]}")
        log(f"[ckpt] {label} B's steps 1-2 equal A's bit for bit")
        del tb
        free()
        os.rename(d, d_disk)  # C finds step 2 in shm alone

        if faults:
            out["faults"] = planted_faults(
                label, result, batch, d, want, hist_a, CheckpointEngine,
                AsyncCheckpointSaver, train_state_leaves)

        _build.reset_launches()
        tc, wall = run(CKPT_STEPS, d)
        counts = {k: v for k, v in _build.launches.items() if v}
        out["C"] = report("C (restored from shm)", tc, wall)
        bad = _differing_leaves(tc.state, want)
        log(f"[ckpt] {label} C launches {counts}; losses and grad norms "
            f"equal A's: {_hist(tc) == hist_a[2:]}; differing leaves "
            f"{len(bad)} of {len(want)}")
        require(all(counts.get(k, 0) > 0 for k in kernels),
                f"{label}: the restored run launched none of some of "
                f"{kernels}")
        require(out["C"]["io"] and out["C"]["io"][0][0] == "restore_shm",
                f"{label}: C did not restore from shm")
        require(_hist(tc) == hist_a[2:] and not bad,
                f"{label}: the run restored from shm is not A's: "
                f"{_hist(tc)} vs {hist_a[2:]}, leaves {bad[:4]}")
        out["persist_C"] = _io_reading("persist")
        del tc
        free()

        drop_shm()  # D finds no segment: it reads the .drckpt
        shutil.rmtree(d, ignore_errors=True)
        td, wall = run(CKPT_STEPS, d_disk)
        out["D"] = report("D (restored from disk)", td, wall)
        bad = _differing_leaves(td.state, want)
        log(f"[ckpt] {label} D: losses and grad norms equal A's: "
            f"{_hist(td) == hist_a[2:]}; differing leaves {len(bad)} of "
            f"{len(want)}")
        require(out["D"]["io"] and out["D"]["io"][0][0]
                == "restore_storage", f"{label}: D did not restore from disk")
        require(_hist(td) == hist_a[2:] and not bad,
                f"{label}: the run restored from disk is not A's: "
                f"{_hist(td)} vs {hist_a[2:]}, leaves {bad[:4]}")
        out["persist_D"] = _io_reading("persist")
        del td
        free()
    finally:
        drop_shm()
        factory.close()
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d_disk, ignore_errors=True)
    del want, result
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ckpt] {label}: A, B, C, D agree bit for bit (C from shm, D "
        "from disk)")
    # a snapshot every step: step k+1 runs beside step k's drain
    alone = out["A"]["steps"][1:]
    beside = [out["B"]["steps"][1], out["C"]["steps"][1],
              out["D"]["steps"][1]]
    log(f"[ckpt] {card} | {label} step on the card's clock, no snapshot "
        f"(A, steps 2-4): {[round(1e3 * t, 3) for t in alone]} ms; beside "
        f"the last step's drain (B step 2, C and D step 4): "
        f"{[round(1e3 * t, 3) for t in beside]} ms")
    return out


def planted_faults(label, result, batch, d, want, hist_a, CheckpointEngine,
                   AsyncCheckpointSaver, train_state_leaves):
    """1. the last byte of one leaf flipped in the newest shm slot: the
    state restored from it, trained to step 4, must differ from A's in
    the leaf comparison; 2. a restore that leaves the optimizer's step
    count at its initial 0: the losses to step 4 must differ from A's."""
    handler = AsyncCheckpointSaver.get_ckpt_saver()._shm_handlers[0]
    meta = handler.meta.get_all()
    key = "['params']['layers']['wq']"
    spec = next(s for s in meta["specs"] if s[0] == key)
    pos = meta["base"] + spec[3] + spec[4] - 1
    dev_batch = {"tokens": torch.from_numpy(batch["tokens"]).cuda()}
    readings = {}
    for fault in ("flipped byte", "skipped step count"):
        engine = CheckpointEngine(d)
        state = result.fns.init_state(0)
        buf = handler._shm.buf
        if fault == "flipped byte":
            buf[pos] ^= 0xFF
        try:
            step, _ = engine.load(target=state)
        finally:
            if fault == "flipped byte":
                buf[pos] ^= 0xFF
            del buf
            engine.close()
        require(step == 2, f"{label}: the faulted restore found step {step}")
        if fault == "skipped step count":
            dict(train_state_leaves(state))["['opt_state'].step"].set(0)
        hist = []
        for _ in range(2):
            _, m = result.fns.train_step(state, dev_batch)
            hist.append((state["step"], float(m["loss"]),
                         float(m["grad_norm"])))
        bad = _differing_leaves(state, want)
        readings[fault] = (len(bad), hist)
        del m
        log(f"[ckpt] {label} planted fault, {fault}"
            f"{' in the last byte of ' + key if fault == 'flipped byte' else ''}"
            f": differing leaves at step 4 {len(bad)} of {len(want)}; steps "
            f"3-4 {hist} against A's {hist_a[2:]}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
    require(readings["flipped byte"][0] > 0,
            f"{label}: the leaf comparison does not see a flipped byte")
    require(readings["skipped step count"][1] != hist_a[2:],
            f"{label}: the loss comparison does not see a skipped step count")
    return readings


def dd_write_gbps(root, nbytes) -> float:
    """Seconds of a ``dd``-style write of ``nbytes`` to ``root``: 64 MiB
    chunks from one buffer, then ``fsync``."""
    path = os.path.join(root, "dd.bin")
    chunk = np.random.default_rng(0).integers(0, 255, 64 << 20,
                                              dtype=np.uint8)
    t = time.perf_counter()
    with open(path, "wb") as f:
        left = nbytes
        while left > 0:
            m = min(left, chunk.nbytes)
            f.write(memoryview(chunk)[:m])
            left -= m
        f.flush()
        os.fsync(f.fileno())
    dur = time.perf_counter() - t
    os.remove(path)
    return nbytes / 1e9 / dur


def ckpt_path(args):
    """The flash-checkpoint leg (the module's docstring, phase 6); returns
    its readings."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common import multi_process
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.optimizers import AGD, QuantizedMoments

    card = smi_line()
    log(f"[ckpt] {card}")
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", f"ckpt_smoke_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    shm_free = shutil.disk_usage("/dev/shm").free
    ram = _mem_available()
    log(f"[ckpt] {_space('/dev/shm')}; {_space(root)}; MemAvailable "
        f"{ram / 1e9:.2f} GB")
    # tmpfs pages are RAM: half of the smaller of the two holds 2 slots
    room = min(shm_free, ram) / 2
    sock = tempfile.mkdtemp(prefix="dts")
    if len(sock) > 60:  # AF_UNIX paths end at 107 bytes
        shutil.rmtree(sock)
        sock = tempfile.mkdtemp(prefix="dts", dir="/tmp")
    os.environ[multi_process.SOCKET_DIR_ENV] = sock
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        args.bf16_reduced_default)
    out = {}
    try:
        rates = pinned_rates(card)
        tokens = np.random.default_rng(SEED).integers(
            0, 32000, (4, 2049)).astype(np.int32)
        for label, int8, mode in (("agd", False, "auto"),
                                  ("int8", True, "staged")):
            if args.ckpt_layers:
                L = args.ckpt_layers
            else:
                L = next((n for n in CKPT_DEPTHS if 2 * _state_bytes(
                    llama.LlamaConfig.llama2_7b(n_layers=n), int8) <= room),
                    None)
                require(L is not None, f"{label}: two slots of even "
                        f"{CKPT_DEPTHS[-1]} layers exceed {room / 1e9:.2f} GB")
            cfg = llama.LlamaConfig.llama2_7b(n_layers=L)
            log(f"[ckpt] {label}: Llama-2-7B widths cut to {L} layers (of "
                f"32), the largest of {CKPT_DEPTHS} whose two shm slots "
                f"({2 * _state_bytes(cfg, int8) / 1e9:.2f} GB) fit in half "
                f"of min(free /dev/shm, MemAvailable) = {room / 1e9:.2f} GB;"
                f" snapshot_mode={mode}")
            if int8:
                make = lambda ps: QuantizedMoments(  # noqa: E731
                    ps, lr=3e-4, weight_decay=0.1)
                kernels = ("rms_norm", "flash_fwd", "int8_adam")
            else:
                make = lambda ps: AGD(ps, lr=3e-4)  # noqa: E731
                kernels = ("rms_norm", "rms_norm_bwd", "flash_fwd",
                           "flash_bwd_dkv", "flash_bwd_dq")
            out[label] = ckpt_leg(label, cfg, make, mode, root, tokens, card,
                                  rates, kernels, faults=not int8)
            b = out[label]
            for k in ("persist_C", "persist_D"):
                log(f"[ckpt] {card} | {label} {k}: {b[k][0] / 1e9:.3f} GB at "
                    f"{b[k][1]:.3f} GB/s")
        nb = out["agd"]["state_bytes"]
        log(f"[ckpt] {card} | dd-style write of {nb / 1e9:.3f} GB to "
            f"{root}: {dd_write_gbps(root, nb):.3f} GB/s (the persist's "
            "yardstick)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(sock, ignore_errors=True)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--profile", action="store_true",
                    help="trace one full-batch decode step per serving "
                    "leg and one step of each training leg")
    ap.add_argument("--skip-serve", action="store_true",
                    help="leave out the serving main path")
    ap.add_argument("--skip-train", action="store_true",
                    help="leave out the training main path")
    ap.add_argument("--train-layers", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=6,
                    help="steps of the AGD and the int8 legs")
    ap.add_argument("--skip-int8", action="store_true",
                    help="leave out the int8-moment training leg")
    ap.add_argument("--int8-layers", type=int, default=32)
    ap.add_argument("--serve-only", action="store_true",
                    help="only the serving main path (its legs and "
                    "captured kernel rows)")
    ap.add_argument("--skip-ckpt", action="store_true",
                    help="leave out the flash-checkpoint leg")
    ap.add_argument("--ckpt-only", action="store_true",
                    help="only the build and the flash-checkpoint leg")
    ap.add_argument("--ckpt-layers", type=int, default=0,
                    help="depth of both checkpoint legs (default: the "
                    f"largest of {CKPT_DEPTHS} whose two shm slots fit)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from dlrover_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2

    # the training leg goes back to PyTorch's default for bf16 GEMMs
    args.bf16_reduced_default = (
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {kind} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {smi}")
    log("[device] TF32 off for matmuls and cuDNN; bf16 matmuls reduce "
        "in fp32 (the training leg: PyTorch's default)")

    secs = _build.build(verbose=True)
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"sources={list(_build.SOURCES)} build_s={secs:.2f}")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            # ptxas's C75xx remarks name wgmma pipelines it serialised
            if ("registers" in line or "spill" in line or "C75" in line
                    or "error" in line.lower()):
                log(f"[build] {name}: {line.strip()}")

    if args.serve_only:
        main_path(args)
        log(smi_line())
        return 0
    if args.ckpt_only:
        ckpt_path(args)
        log(smi_line())
        return 0
    kernel_checks()
    flash_checks()
    int8_checks()
    tiny_parity()
    train_parity()
    rows = []
    if not (args.kernels_only or args.skip_serve):
        rows += main_path(args)
    if not (args.kernels_only or args.skip_train):
        rows += train_path(args)
    if not (args.kernels_only or args.skip_int8):
        rows += int8_path(args)
    if not (args.kernels_only or args.skip_ckpt):
        ckpt_path(args)

    if rows:
        log(json.dumps({"kernels": rows}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
