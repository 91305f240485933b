#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``dlrover_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper
card::

    python3 chip_smoke.py            # everything, as the chip check runs it
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --layers 4 # main path at reduced depth
    python3 chip_smoke.py --profile  # + a torch.profiler decode step

Phases (any failed check raises, so the script exits nonzero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 and
   reduced-precision bf16 reductions are switched off for every matmul.
2. build: the three kernels of the serving path from ``ops/csrc`` (one
   ``nvcc`` per source, in parallel), with the build seconds and the
   ``ptxas`` register report.
3. kernels against their plain PyTorch versions on the card, bf16 and
   fp32, at full width (RMSNorm D=4096 and 8192; attention head_dim=128,
   GQA group 1/4/8, block_size 16, ragged lengths including 0 and a full
   table, inactive lanes on the null block, 1e4 and NaN poison in the
   null block and the guard blocks, verify window C=4); then a small
   fp32 Llama served on the card and on the CPU from the same params,
   whose greedy tails and K=3 acceptance counts must agree (K=1 and
   K=3, with preemption).
4. main path: Llama-2-7B at full width and depth (bf16, random weights
   from a seeded generator on the card) served by the continuous-batching
   scheduler over the paged pool: 16 requests with 128-1024-token prompts
   and 64 new tokens each, once with K=1 and once with
   ``DLROVER_TPU_DECODE_STEPS=4``.  Launch counters are zeroed just
   before each leg and read just after; every kernel must have launched.
   The greedy tails of the two legs must be identical, and the K=4 leg
   must accept at least ``ACCEPT_FLOOR`` drafts per window.  One layer's
   inputs of one decode step and one verify step are captured, and each
   kernel is held against its plain version on them and timed there.
5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

It exits nonzero without printing a result when CUDA is unavailable or
when the package is not beside it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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


def check_rms(rms_fwd, rms_plain, dtype, n, d, gen) -> float:
    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    y, rstd = rms_fwd(x, w, 1e-5)
    torch.cuda.synchronize()
    y_ref, rstd_ref = rms_plain(x, w, 1e-5)
    err = max_err(y, y_ref)
    rerr = max_err(rstd, rstd_ref) / float(rstd_ref.abs().max())
    # fp32: summation order only; bf16: one rounding of |y| < 16 may
    # land one ulp (<= 2^-4) apart
    ok = err <= RMS_TOL[dtype] and rerr <= 1e-5
    log(f"[check] rms_norm {str(dtype)[6:]} N={n} D={d} "
        f"max_abs_err={err:.3g} rstd_rel_err={rerr:.3g} "
        f"tol={RMS_TOL[dtype]} {'ok' if ok else 'FAIL'}")
    require(ok, f"rms_norm {dtype} N={n} D={d}")
    return err


def attention_case(group, dtype, poison, gen, batch=6, kv=4, head_dim=128,
                   block_size=16, max_blocks=8, window=4):
    """Pools with normal K/V in lanes' blocks and poison in the null
    block and in the guard block every unused table entry points at;
    ragged lengths including 0, a full table and an inactive lane
    (length 1 on table row 0)."""
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
    seq_lens = torch.tensor(
        [1, 0, block_size + block_size // 2, block_size * max_blocks,
         37, 1][:batch], dtype=torch.int32, device="cuda")
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


def check_attention(pk, kind, group, dtype, poison, gen) -> float:
    c = attention_case(group, dtype, poison, gen)
    if kind == "decode":
        args = (c["q"], c["k_pool"], c["v_pool"], c["tables"], c["seq_lens"])
        out = pk.paged_decode_kernel(*args)
        torch.cuda.synchronize()
        ref = pk.paged_decode_plain(*args)
        empty = out[1]
    else:
        args = (c["qv"], c["k_pool"], c["v_pool"], c["tables"],
                c["positions"])
        out = pk.paged_verify_kernel(*args)
        torch.cuda.synchronize()
        ref = pk.paged_verify_plain(*args)
        empty = None
    # the last lane is inactive: its output is discarded by the model,
    # so it only has to run without a fault
    live = out[:-1]
    err = max_err(live, ref[:-1])
    ok = (
        err <= ATTN_TOL[dtype]
        and bool(torch.isfinite(live).all())
        and float(live.float().abs().max()) < POISON / 10
        and (empty is None or bool((empty == 0).all()))
    )
    log(f"[check] paged_{kind} {str(dtype)[6:]} group={group} "
        f"poison={poison} max_abs_err={err:.3g} tol={ATTN_TOL[dtype]} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"paged_{kind} {dtype} group={group} poison={poison}")
    return err


def kernel_checks():
    from dlrover_tpu_torch.ops import fused
    from dlrover_tpu_torch.ops import paged_kernels as pk

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for n, d in ((1, 4096), (16, 4096), (257, 4096), (64, 8192)):
            check_rms(fused.rms_norm_fwd, fused.rms_norm_plain, dtype, n, d,
                      gen)
        for kind in ("decode", "verify"):
            for group in (1, 4, 8):
                for poison in (POISON, float("nan")):
                    check_attention(pk, kind, group, dtype, poison, gen)


# ----------------------------------------------------------- main path


def tiny_parity():
    """End to end against the plain path: a small fp32 Llama served on
    the card (kernels) and on the CPU (plain versions) from the same
    params must give the same greedy tails, for K=1 and the K=3 window,
    on a pool small enough to force preemption and resume."""
    from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
    from dlrover_tpu_torch.rl.scheduler import (
        ContinuousBatchingScheduler,
        SchedulerConfig,
    )

    cfg = LlamaConfig.tiny(vocab_size=97, dim=128, n_heads=4, n_kv_heads=2,
                           mlp_dim=256, dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v.cuda()) for k, v in cpu.items()}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, 97, size=int(n)).astype(np.int32)
               for n in rng.integers(2, 10, size=6)]
    sched = SchedulerConfig(max_slots=4, block_size=4, num_blocks=9,
                            max_seq_len=64, prefill_chunk=3,
                            temperature=0.0)
    env = {"DLROVER_TPU_KV_ADMIT_WATERMARK": "0",
           "DLROVER_TPU_KV_GROW_BLOCKS": "1"}
    saved = {k: os.environ.get(k) for k in [*env, "DLROVER_TPU_DECODE_STEPS"]}
    os.environ.update(env)
    try:
        for k in (1, 3):
            os.environ["DLROVER_TPU_DECODE_STEPS"] = str(k)
            tails, counts = [], []
            for device, params in (("cpu", cpu), ("cuda", gpu)):
                sch = ContinuousBatchingScheduler(cfg, sched, device=device)
                sch.sync_weights(params)
                for i, p in enumerate(prompts):
                    sch.submit(p, max_new=12, seed=i)
                tails.append({r.req_id: r.tokens for r in sch.run()})
                st = sch.stats()
                counts.append({n: st[n] for n in (
                    "preemptions", "accepted_tokens", "lane_windows")})
            same = tails[0].keys() == tails[1].keys() and all(
                np.array_equal(tails[0][i], tails[1][i]) for i in tails[0])
            # at temperature 0 the tails are the draft (decode) stream;
            # only the acceptance counts read the verify kernel's output
            log(f"[parity] tiny fp32 K={k}: card tails == CPU tails: {same}; "
                f"cpu {counts[0]} card {counts[1]}")
            require(same and counts[0] == counts[1]
                    and counts[1]["preemptions"] >= 1,
                    f"tiny fp32 K={k}: card and CPU disagree")
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value




class Capture:
    """Wraps one kernel entry of ``models.llama``.  Among the calls it
    considers (every ``every``-th: layer 0 of each step), it keeps a
    copy of the inputs and the output of the first one at the highest
    ``score()`` (the number of lanes decoding, read on the host)."""

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

    def __call__(self, *args):
        out = self.orig(*args)
        if self.calls % self.every == 0 and self.when(*args):
            score = self.score()
            if score > self.best:
                self.best = score
                self.args = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args
                )
                self.out = out.clone()
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
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA
    ]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"[profile] {label}: wall_ms={wall_ms:.3f} (profiler on) "
        f"device_kernel_ms={total_ms:.3f} kernel_launches={launches} "
        f"device_busy_share={total_ms / wall_ms:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return n


def serve_leg(cfg, params, sched_cfg, prompts, k, max_new, captures,
              profile=False):
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.rl.scheduler import ContinuousBatchingScheduler

    os.environ["DLROVER_TPU_DECODE_STEPS"] = str(k)
    sch = ContinuousBatchingScheduler(cfg, sched_cfg)
    sch.sync_weights(params)
    decode_s, full_s = [], []
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
        n = inner(finished)
        if n:  # the step ends in a host copy of the sampled tokens
            decode_s.append(time.perf_counter() - t0)
            if full:
                full_s.append(decode_s[-1])
        return n

    if k > 1:
        sch._decode_multi_once = timed
    else:
        sch._decode_once = timed
    active = lambda: int(sch._active.sum())  # noqa: E731
    caps = [Capture(llama, score=active, **c) for c in captures]
    for i, p in enumerate(prompts):
        sch.submit(p, max_new=max_new, seed=100 + i)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    results = sch.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    for c in caps:
        c.restore()
    stats = sch.stats()
    del sch
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


def rms_bound_ms(x):
    n, d = x.numel() // x.shape[-1], x.shape[-1]
    item = x.element_size()
    nbytes = 2 * n * d * item + d * item + 4 * n
    return bound(nbytes, 4 * n * d, x.dtype)


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


def kernel_row(name, source, replaces, launches, err, tol, fn, plain,
               library, bnd):
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, reps=3)
    library_ms = cuda_ms(library) if library is not None else None
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
        "bound_by": bnd[1], "library_ms": library_ms,
    }


def main_path(args):
    import torch.nn.functional as F

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
    tails1, counts1, caps1, _ = serve_leg(
        cfg, params, sched_cfg, prompts, 1, args.max_new, [
            dict(attr="paged_decode_attention", every=L),
            dict(attr="rms_norm",
                 when=lambda x, *_: tuple(x.shape[:2]) == (16, 1)),
        ], profile=args.profile,
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
    dec, rms = caps1
    ver = caps4[0]
    require(dec.args is not None and rms.args is not None
            and ver.args is not None, "a capture point was never reached")
    rows = []

    # RMSNorm on the captured decode-step input
    x, w, eps = rms.args
    x2 = x.reshape(-1, x.shape[-1])
    y, _ = fused.rms_norm_fwd(x2, w, eps)
    y_plain, _ = fused.rms_norm_plain(x2, w, eps)
    err = max_err(y, y_plain)
    require(torch.equal(y.reshape(rms.out.shape), rms.out),
            "rms_norm rerun differs from the main path's output")
    log(f"[captured] rms_norm {tuple(x.shape)} max_abs_err={err:.3g} "
        f"tol={RMS_TOL[x.dtype]}")
    require(err <= RMS_TOL[x.dtype], "rms_norm on captured input")
    rows.append(kernel_row(
        "rms_norm", "dlrover_tpu_torch/ops/csrc/rms_norm.cu",
        "dlrover_tpu/ops/fused.py:48", launches["rms_norm"], err,
        RMS_TOL[x.dtype],
        lambda: fused.rms_norm_fwd(x2, w, eps),
        lambda: fused.rms_norm_plain(x2, w, eps),
        lambda: F.rms_norm(x2, (x2.shape[-1],), w, eps),
        rms_bound_ms(x2),
    ))

    for name, cap, window, replaces, kern, plain in (
        ("paged_decode", dec, None, "dlrover_tpu/ops/paged_kernels.py:128",
         pk.paged_decode_kernel, pk.paged_decode_plain),
        ("paged_verify", ver, 4, "dlrover_tpu/ops/paged_kernels.py:289",
         pk.paged_verify_kernel, pk.paged_verify_plain),
    ):
        a = cap.args
        out = kern(*a)
        ref = plain(*a)
        require(torch.equal(out, cap.out),
                f"{name} rerun differs from the main path's output")
        err = max_err(out, ref)
        log(f"[captured] {name} q={tuple(a[0].shape)} "
            f"lens/pos={a[4].tolist()} max_abs_err={err:.3g} "
            f"tol={ATTN_TOL[a[0].dtype]}")
        require(err <= ATTN_TOL[a[0].dtype], f"{name} on captured input")
        rows.append(kernel_row(
            name, "dlrover_tpu_torch/ops/csrc/paged_attention.cu", replaces,
            launches[name], err, ATTN_TOL[a[0].dtype],
            lambda: kern(*a), lambda: plain(*a),
            sdpa_decode_fn(*a, window),
            attn_bound_ms(a[0], a[1], a[4], window),
        ))
    for r in rows:
        log(f"[time] {r['name']} ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"launches={r['launches']}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--profile", action="store_true",
                    help="trace one full-batch decode step per leg")
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
        "in fp32")

    secs = _build.build(verbose=True)
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"sources={list(_build.SOURCES)} build_s={secs:.2f}")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")

    kernel_checks()
    tiny_parity()
    rows = [] if args.kernels_only else main_path(args)

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
