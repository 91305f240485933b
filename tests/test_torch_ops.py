"""The port's kernel modules against the JAX package, on the CPU.

Every case makes its inputs from a seed with numpy and feeds the same
arrays to the JAX function and to its port.  The port's tensors lie on
the CPU, so its wrappers take their plain PyTorch versions (the CUDA
kernels are held against those on the card by ``chip_smoke.py``).  The
Pallas kernels run in interpret mode, as their own tests run them here.

Tolerances: fp32 atol 1e-6 (RMSNorm) and 1e-5 (attention; online vs
two-pass softmax and another summation order); bf16 RMSNorm within one
bf16 ulp, the residual add before it (``add_rms_norm``) bit for bit; bf16 attention 6e-2, the JAX package's own bound for kernel
against reference (the reference rounds the weights to bf16 before
``p @ v``, the kernel does not).
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.ops import paged_attention as jpa  # noqa: E402
from dlrover_tpu.ops.fused import (  # noqa: E402
    _rms_bwd,
    _rms_fwd_pallas,
    _rms_plain,
)
from dlrover_tpu.ops.paged_kernels import (  # noqa: E402
    paged_decode_kernel as jax_decode_kernel,
    paged_verify_kernel as jax_verify_kernel,
)
from dlrover_tpu_torch.ops import _build  # noqa: E402
from dlrover_tpu_torch.ops import fused  # noqa: E402
from dlrover_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from dlrover_tpu_torch.ops import paged_kernels as tpk  # noqa: E402

POISON = 1e4
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _case(group, block_size, seed=0, batch=4, kv=2, head_dim=8,
          max_blocks=4, window=3, poison=POISON):
    """The scenario grid of ``tests/test_paged_kernels.py:_case``, as
    numpy: poison in the null block and in the guard block that every
    table entry past a lane's resident blocks points at; ragged
    ``seq_lens`` with an empty lane and a lane using the full table."""
    rng = np.random.default_rng(seed)
    heads = kv * group
    used = batch * max_blocks
    num_blocks = 1 + used + 1
    shape = (num_blocks, block_size, kv, head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    for pool in (k_pool, v_pool):
        pool[0] = poison
        pool[-1] = poison
    tables = (1 + np.arange(used).reshape(batch, max_blocks)).astype(
        np.int32)
    seq_lens = np.array(
        [1, 0, block_size + block_size // 2, block_size * max_blocks],
        np.int32)[:batch]
    q = rng.standard_normal((batch, heads, head_dim)).astype(np.float32)
    qv = rng.standard_normal(
        (batch, window, heads, head_dim)).astype(np.float32)
    positions = np.maximum(seq_lens - window, 0).astype(np.int32)
    for b in range(batch):
        covered = max(int(seq_lens[b]), int(positions[b]) + window)
        tables[b, -(-covered // block_size):] = num_blocks - 1
    return dict(q=q, qv=qv, k_pool=k_pool, v_pool=v_pool, tables=tables,
                 seq_lens=seq_lens, positions=positions)


def _jax(c, dtype="float32"):
    dt = JAX_DT[dtype]
    return {k: (jnp.asarray(v, dt) if v.dtype == np.float32
                else jnp.asarray(v)) for k, v in c.items()}


def _torch(c, dtype="float32"):
    dt = TORCH_DT[dtype]
    return {k: (_t(v, dt) if v.dtype == np.float32 else _t(v))
            for k, v in c.items()}


@pytest.fixture(autouse=True)
def _zero_launches():
    _build.reset_launches()
    yield
    # CPU tensors take the plain versions: no kernel ever launched
    assert all(n == 0 for n in _build.launches.values())


# ------------------------------------------------------------- RMSNorm


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 64), (1, 4096)])
def test_rms_norm_matches_jax_plain(dtype, shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = 1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32)
    y_j, rstd_j = _rms_plain(
        jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(w, JAX_DT[dtype]), 1e-5)
    y_t, rstd_t = fused.rms_norm_fwd(
        _t(x, TORCH_DT[dtype]), _t(w, TORCH_DT[dtype]), 1e-5)
    assert y_t.dtype == TORCH_DT[dtype]
    assert rstd_t.dtype == torch.float32 and rstd_t.shape == shape[:-1] + (1,)
    np.testing.assert_allclose(_np(rstd_t), _np(rstd_j), rtol=1e-6)
    ref = _np(y_j)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y_t), ref, atol=1e-6, rtol=0)
    else:
        assert np.all(np.abs(_np(y_t) - ref) <= _bf16_ulp(ref))
    np.testing.assert_array_equal(
        _np(fused.rms_norm(_t(x, TORCH_DT[dtype]),
                           _t(w, TORCH_DT[dtype]), 1e-5)),
        _np(y_t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_pallas_interpret(dtype):
    """The Pallas forward kernel itself (interpret mode), N % 8 == 0
    and D = 128 as its tiling needs."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    y_j, rstd_j = _rms_fwd_pallas(
        jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(w, JAX_DT[dtype]), 1e-5)
    y_t, rstd_t = fused.rms_norm_plain(
        _t(x, TORCH_DT[dtype]), _t(w, TORCH_DT[dtype]), 1e-5)
    np.testing.assert_allclose(_np(rstd_t), _np(rstd_j), rtol=1e-6)
    ref = _np(y_j)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y_t), ref, atol=1e-6, rtol=0)
    else:
        assert np.all(np.abs(_np(y_t) - ref) <= _bf16_ulp(ref))


def _close_rms(y_t, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(y_t), ref, atol=1e-6, rtol=0)
    else:
        assert np.all(np.abs(_np(y_t) - ref) <= _bf16_ulp(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_matches_jax_add_then_plain_and_pallas(dtype):
    """The residual entry against the reference's unfused sequence: JAX's
    ``x + d`` in the working dtype, then ``_rms_plain`` and the Pallas
    forward kernel (interpret mode) on it.  ``h`` equal bit for bit;
    ``y`` within one bf16 ulp (fp32: 1e-6)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 128)).astype(np.float32) * 2
    d = rng.standard_normal((16, 128)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jh = jnp.asarray(x, JAX_DT[dtype]) + jnp.asarray(d, JAX_DT[dtype])
    jw = jnp.asarray(w, JAX_DT[dtype])
    h_t, y_t, rstd_t = fused.add_rms_norm_fwd(
        _t(x, TORCH_DT[dtype]), _t(d, TORCH_DT[dtype]),
        _t(w, TORCH_DT[dtype]), 1e-5)
    assert h_t.dtype == y_t.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(_np(h_t), _np(jh))
    for y_j, rstd_j in (_rms_plain(jh, jw, 1e-5),
                        _rms_fwd_pallas(jh, jw, 1e-5)):
        np.testing.assert_allclose(_np(rstd_t), _np(rstd_j), rtol=1e-6)
        _close_rms(y_t, _np(y_j), dtype)
    h2, y2 = fused.add_rms_norm(_t(x, TORCH_DT[dtype]),
                                _t(d, TORCH_DT[dtype]),
                                _t(w, TORCH_DT[dtype]), 1e-5)
    assert torch.equal(h2, h_t) and torch.equal(y2, y_t)


@pytest.mark.parametrize("entry", ["rms_norm", "add_rms_norm",
                                   "rms_norm_bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_odd_width_matches_jax(entry, dtype):
    """D = 100, not a multiple of any vector width (the kernels take
    their scalar path there): the plain entries against the reference's
    ``_rms_plain`` and ``_rms_bwd`` (``dw`` summed in fp32 over 7 rows:
    1e-5)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 100)).astype(np.float32)
    d = rng.standard_normal((7, 100)).astype(np.float32)
    g = rng.standard_normal((7, 100)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(100)).astype(np.float32)
    jdt, tdt = JAX_DT[dtype], TORCH_DT[dtype]
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jnp.float32)
    tx, tw = _t(x, tdt), _t(w)
    if entry == "rms_norm":
        y_j, rstd_j = _rms_plain(jx, jw, 1e-5)
        y_t, rstd_t = fused.rms_norm_fwd(tx, tw, 1e-5)
    elif entry == "add_rms_norm":
        jh = jx + jnp.asarray(d, jdt)
        y_j, rstd_j = _rms_plain(jh, jw, 1e-5)
        h_t, y_t, rstd_t = fused.add_rms_norm_fwd(tx, _t(d, tdt), tw, 1e-5)
        np.testing.assert_array_equal(_np(h_t), _np(jh))
    else:
        _, rstd_j = _rms_plain(jx, jw, 1e-5)
        dx_j, dw_j = _rms_bwd(1e-5, (jx, jw, rstd_j), jnp.asarray(g, jdt))
        dx_t, dw_t = fused.rms_norm_bwd(
            tx, tw, _t(np.asarray(rstd_j)), _t(g, tdt))
        assert dx_t.dtype == tdt and dw_t.dtype == torch.float32
        _close_rms(dx_t, _np(dx_j), dtype)
        np.testing.assert_allclose(_np(dw_t), _np(dw_j), atol=1e-5, rtol=0)
        return
    np.testing.assert_allclose(_np(rstd_t), _np(rstd_j), rtol=1e-6)
    _close_rms(y_t, _np(y_j), dtype)


# ---------------------------------------------------- decode / verify


GRID = [(g, bs) for g in (1, 2, 4) for bs in (8, 16)]


@pytest.mark.parametrize("group,block_size", GRID)
def test_decode_matches_jax_reference(group, block_size):
    c = _case(group, block_size)
    j, t = _jax(c), _torch(c)
    ref = jpa.paged_decode_attention(
        j["q"], j["k_pool"], j["v_pool"], j["tables"], j["seq_lens"],
        backend="jnp")
    out = tpa.paged_decode_attention(
        t["q"], t["k_pool"], t["v_pool"], t["tables"], t["seq_lens"])
    assert out.shape == (4, 2 * group, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)
    assert float(out.abs().max()) < POISON / 10
    assert bool((out[1] == 0).all())  # the empty lane: exact zeros


@pytest.mark.parametrize("group,block_size", GRID)
def test_verify_matches_jax_reference(group, block_size):
    c = _case(group, block_size)
    j, t = _jax(c), _torch(c)
    ref = jpa.paged_verify_attention(
        j["qv"], j["k_pool"], j["v_pool"], j["tables"], j["positions"],
        backend="jnp")
    out = tpa.paged_verify_attention(
        t["qv"], t["k_pool"], t["v_pool"], t["tables"], t["positions"])
    assert out.shape == (4, 3, 2 * group, 8)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)
    assert float(out.abs().max()) < POISON / 10


@pytest.mark.parametrize("group,block_size", [(1, 16), (2, 8), (4, 16)])
def test_decode_matches_pallas_interpret(group, block_size):
    c = _case(group, block_size, seed=3)
    j, t = _jax(c), _torch(c)
    ref = jax_decode_kernel(
        j["q"], j["k_pool"], j["v_pool"], j["tables"], j["seq_lens"])
    out = tpk.paged_decode_kernel(
        t["q"], t["k_pool"], t["v_pool"], t["tables"], t["seq_lens"])
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("group,block_size", [(1, 8), (2, 16), (4, 8)])
def test_verify_matches_pallas_interpret(group, block_size):
    c = _case(group, block_size, seed=4)
    j, t = _jax(c), _torch(c)
    ref = jax_verify_kernel(
        j["qv"], j["k_pool"], j["v_pool"], j["tables"], j["positions"])
    out = tpk.paged_verify_kernel(
        t["qv"], t["k_pool"], t["v_pool"], t["tables"], t["positions"])
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("group,block_size,window,zero_pos", [
    (8, 16, 4, False), (8, 8, 4, True), (1, 8, 4, True), (4, 16, 2, True),
])
def test_verify_window_matches_pallas_interpret(group, block_size, window,
                                                zero_pos):
    """Beyond ``GRID``: group 8 with a window of 4 (32 query rows per KV
    head, the split-KV kernel's widest block) and every lane at position
    0 (the window's own first key is the lane's only prefix)."""
    c = _case(group, block_size, seed=9, window=window)
    if zero_pos:
        c["positions"] = np.zeros_like(c["positions"])
    j, t = _jax(c), _torch(c)
    ref = jax_verify_kernel(
        j["qv"], j["k_pool"], j["v_pool"], j["tables"], j["positions"])
    out = tpk.paged_verify_kernel(
        t["qv"], t["k_pool"], t["v_pool"], t["tables"], t["positions"])
    assert out.shape == (4, window, 2 * group, 8)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)
    assert float(out.abs().max()) < POISON / 10


@pytest.mark.parametrize("max_blocks,block_size,pages,splits", [
    (1, 16, 8, 1),      # a one-page table: one split
    (128, 16, 8, 16),   # the serving pool's tables (2048 / 16)
    (8, 16, 8, 1),      # one split per lane: the table fits in a split
    (5, 8, 16, 1),
    (300, 1, 128, 3),   # a split is at most 128 keys
    (7, 256, 1, 7),     # a page larger than a split: one page each
])
def test_verify_plan_sizes_splits_and_workspace(max_blocks, block_size,
                                                pages, splits):
    plan = tpk.verify_plan(13, 32, 4, max_blocks, block_size)
    assert plan == (pages, splits, (13, 4, splits, 32))
    # every page of the table lies in exactly one split
    assert (splits - 1) * pages < max_blocks <= splits * pages


@pytest.mark.parametrize("max_blocks,block_size,heads,kv,pages,splits", [
    (128, 16, 32, 32, 8, 16),  # the serving shape: Llama-2-7B, MHA
    (1, 16, 4, 2, 8, 1),       # a one-page table
    (24, 16, 32, 4, 8, 3),     # group 8
    (300, 1, 8, 8, 128, 3),    # a split is at most 128 keys
    (7, 256, 4, 1, 1, 7),      # a page larger than a split
])
def test_decode_plan_sizes_splits_and_workspace(max_blocks, block_size,
                                                heads, kv, pages, splits):
    """The decode kernel's splits are the verify kernel's, from the
    table width and page size alone, with the G = heads / kv query rows
    of one KV head as the workspace's rows."""
    plan = tpk.decode_plan(16, heads, kv, max_blocks, block_size)
    assert plan == (pages, splits, (16, kv, splits, heads // kv))
    assert plan == tpk.verify_plan(16, heads // kv, kv, max_blocks,
                                   block_size)
    assert (splits - 1) * pages < max_blocks <= splits * pages


@pytest.mark.parametrize("kind", ["decode", "verify"])
@pytest.mark.parametrize("head_dim", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_head_dims_match_pallas_interpret(kind, head_dim, dtype):
    """head_dim 16 (``LlamaConfig.tiny()``) and 32, which the kernels now
    take: the port's decode and verify against the Pallas kernels in
    interpret mode, GQA group 2, fp32 and bf16 (bf16 within the JAX
    package's own kernel-vs-reference bound)."""
    c = _case(2, 8, seed=11, head_dim=head_dim)
    j, t = _jax(c, dtype), _torch(c, dtype)
    tpk._check_inputs(t["q"], t["k_pool"], t["v_pool"], t["tables"],
                      t["seq_lens"], f"paged_{kind}")
    if kind == "decode":
        ref = jax_decode_kernel(j["q"], j["k_pool"], j["v_pool"],
                                j["tables"], j["seq_lens"])
        out = tpk.paged_decode_kernel(t["q"], t["k_pool"], t["v_pool"],
                                      t["tables"], t["seq_lens"])
        assert bool((out[1] == 0).all())  # the empty lane: exact zeros
    else:
        ref = jax_verify_kernel(j["qv"], j["k_pool"], j["v_pool"],
                                j["tables"], j["positions"])
        out = tpk.paged_verify_kernel(t["qv"], t["k_pool"], t["v_pool"],
                                      t["tables"], t["positions"])
    assert out.shape[-1] == head_dim
    atol = 1e-5 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=0)
    assert float(out.float().abs().max()) < POISON / 10


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_bf16_matches_jax_reference(kind):
    c = _case(2, 8, seed=5)
    j, t = _jax(c, "bfloat16"), _torch(c, "bfloat16")
    qkey, lkey = ("q", "seq_lens") if kind == "decode" else ("qv",
                                                             "positions")
    jfn = getattr(jpa, f"paged_{kind}_attention")
    tfn = getattr(tpa, f"paged_{kind}_attention")
    ref = jfn(j[qkey], j["k_pool"], j["v_pool"], j["tables"], j[lkey],
              backend="jnp")
    out = tfn(t[qkey], t["k_pool"], t["v_pool"], t["tables"], t[lkey])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), atol=6e-2, rtol=0)


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_nan_poison_never_reaches_live_lanes(kind):
    """NaN in the null block and the guard block: the plain versions
    exclude masked rows rather than multiply them by 0, so the output
    is the one computed from the 1e4-poisoned pools."""
    t_nan = _torch(_case(2, 8, poison=float("nan")))
    t_big = _torch(_case(2, 8))
    fn = tpk.paged_decode_kernel if kind == "decode" else \
        tpk.paged_verify_kernel
    qkey, lkey = ("q", "seq_lens") if kind == "decode" else ("qv",
                                                             "positions")
    outs = [fn(t[qkey], t["k_pool"], t["v_pool"], t["tables"], t[lkey])
            for t in (t_nan, t_big)]
    assert bool(torch.isfinite(outs[0]).all())
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


def test_verify_window_of_one_is_decode():
    c = _case(2, 16, seed=6)
    t = _torch(c)
    lens = t["seq_lens"].clamp(min=1)
    dec = tpk.paged_decode_kernel(
        t["q"], t["k_pool"], t["v_pool"], t["tables"], lens)
    ver = tpk.paged_verify_kernel(
        t["q"][:, None], t["k_pool"], t["v_pool"], t["tables"], lens - 1)
    torch.testing.assert_close(ver[:, 0], dec, atol=1e-6, rtol=0)


# ----------------------------------------------- prefill and KV write


@pytest.mark.parametrize("group,start", [(1, 0), (2, 5), (4, 9)])
def test_prefill_attention_matches_jax(group, start):
    rng = np.random.default_rng(7)
    bs, kv, d, mb, chunk = 4, 2, 8, 6, 6
    nb = 1 + mb
    k_pool = rng.standard_normal((nb, bs, kv, d)).astype(np.float32)
    v_pool = rng.standard_normal((nb, bs, kv, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, nb)).astype(np.int32)
    q = rng.standard_normal((chunk, kv * group, d)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.int32(start))
    out = tpa.paged_prefill_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(table), start)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)


def test_write_block_kv_matches_jax_in_place():
    rng = np.random.default_rng(8)
    shape = (5, 4, 2, 8)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    k_new = rng.standard_normal((6, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((6, 2, 8)).astype(np.float32)
    # two inactive lanes collide on the null block by design
    blocks = np.array([1, 3, 0, 4, 0, 2], np.int32)
    offs = np.array([0, 3, 0, 1, 0, 2], np.int32)
    jk, jv = jpa.write_block_kv(
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(blocks), jnp.asarray(offs))
    tk, tv = _t(k_pool), _t(v_pool)
    rk, rv = tpa.write_block_kv(
        tk, tv, _t(k_new), _t(v_new), _t(blocks), _t(offs))
    assert rk is tk and rv is tv  # updated in place
    np.testing.assert_array_equal(_np(tk)[1:], _np(jk)[1:])
    np.testing.assert_array_equal(_np(tv)[1:], _np(jv)[1:])


# --------------------------------------------------- device dispatch


def test_unsupported_device_raises_instead_of_falling_back():
    """Only CPU tensors take the plain versions; anything else (here a
    meta tensor) raises rather than silently running on the host."""
    x = torch.empty(4, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused.rms_norm(x, w)
    c = _torch(_case(1, 8))
    with pytest.raises(ValueError, match="device"):
        tpk.paged_decode_kernel(
            c["q"].to("meta"), c["k_pool"], c["v_pool"], c["tables"],
            c["seq_lens"])


def test_on_cpu_rule():
    cpu = torch.zeros(2)
    assert _build.on_cpu(cpu, cpu)
    with pytest.raises(ValueError):
        _build.on_cpu(cpu, torch.zeros(2, device="meta"))


def test_launch_counters_exist_and_reset():
    assert set(_build.launches) == {
        "rms_norm", "rms_norm_bwd", "paged_decode", "paged_verify",
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "quantize",
        "dequantize", "int8_adam"}
    _build.launches["rms_norm"] = 3
    _build.reset_launches()
    assert _build.launches["rms_norm"] == 0


def _bad_inputs():
    c = _torch(_case(2, 8, head_dim=128))
    q, kp, vp, tb, ln = (c["q"], c["k_pool"], c["v_pool"], c["tables"],
                         c["seq_lens"])
    misaligned = torch.empty(q.numel() + 1)[1:].view(q.shape)
    misaligned.copy_(q)  # rows start 4 bytes past a 16-byte boundary
    return [
        ("fp16", (q.half(), kp.half(), vp.half(), tb, ln), TypeError),
        ("pool dtype", (q, kp.double(), vp, tb, ln), TypeError),
        ("int64 tables", (q, kp, vp, tb.long(), ln), TypeError),
        ("strided q", (q.transpose(0, 1).contiguous().transpose(0, 1),
                       kp, vp, tb, ln), ValueError),
        ("head_dim 48", (q[..., :48].contiguous(),
                         kp[..., :48].contiguous(),
                         vp[..., :48].contiguous(), tb, ln), ValueError),
        ("heads % kv", (q[:, :3].contiguous(), kp, vp, tb, ln),
         ValueError),
        ("lens shape", (q, kp, vp, tb, ln[:2]), ValueError),
        ("misaligned", (misaligned, kp, vp, tb, ln), ValueError),
    ]


@pytest.mark.parametrize("idx", range(8))
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(idx):
    """The CUDA wrapper's checks run before any launch, so they can be
    exercised on CPU tensors."""
    name, args, err = _bad_inputs()[idx]
    with pytest.raises(err):
        tpk._check_inputs(*args, "paged_decode")


def test_verify_wrapper_needs_16_byte_aligned_pools():
    """Both split-KV kernels copy pool rows 16 bytes at a time
    (``cp.async``): a pool 8 bytes off a 16-byte boundary (whole rows of
    head_dim 64 in fp32 still start 8-byte aligned) is refused by the
    verify wrapper and, since the decode kernel went split-KV, by the
    decode wrapper too, before any launch; the aligned pool passes."""
    c = _torch(_case(2, 8, head_dim=64))
    kp = c["k_pool"]
    off = torch.empty(kp.numel() + 2)[2:].view(kp.shape)
    off.copy_(kp)
    assert off.data_ptr() % 16 == 8
    tpk._check_inputs(c["qv"], kp, c["v_pool"], c["tables"],
                      c["positions"], "paged_verify")
    with pytest.raises(ValueError, match="16-byte"):
        tpk._check_inputs(c["qv"], off, c["v_pool"], c["tables"],
                          c["positions"], "paged_verify")
    with pytest.raises(ValueError, match="16-byte"):
        tpk._check_inputs(c["q"], off, c["v_pool"], c["tables"],
                          c["seq_lens"], "paged_decode")


def test_kernel_wrapper_accepts_the_main_path_layout():
    c = _torch(_case(2, 8, head_dim=128))
    tpk._check_inputs(c["q"], c["k_pool"], c["v_pool"], c["tables"],
                      c["seq_lens"], "paged_decode")


@pytest.mark.parametrize("case", ["delta shape", "delta dtype", "g shape",
                                  "rstd dtype", "strided g"])
def test_norm_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The residual and backward entries check before any launch (so on
    CPU tensors): ``delta``, ``g`` and ``g_res`` alike with ``x``,
    contiguous, and ``rstd`` fp32, one per row."""
    x = torch.randn(4, 64)
    w = torch.ones(64)
    rstd = torch.ones(4, 1)
    if case.startswith("delta"):
        delta = (torch.randn(4, 32) if case == "delta shape"
                 else torch.randn(4, 64).double())
        with pytest.raises(ValueError):
            fused._launch_fwd(x, delta, w, 1e-5)
        return
    g = torch.randn(4, 64)
    if case == "g shape":
        g = torch.randn(4, 32)
    elif case == "rstd dtype":
        rstd = rstd.double()
    else:
        g = torch.randn(64, 4).t()
    with pytest.raises(ValueError):
        fused._rms_norm_bwd_cuda(x, w, rstd, g, None)


@pytest.mark.parametrize("case", ["fp16", "weight dtype", "weight shape"])
def test_rms_norm_wrapper_refuses_bad_inputs(case):
    x = torch.randn(4, 64)
    w = torch.ones(64)
    if case == "fp16":
        x, w = x.half(), w.half()
    elif case == "weight dtype":
        w = w.double()
    else:
        w = torch.ones(32)
    with pytest.raises((TypeError, ValueError)):
        fused._rms_norm_cuda(x, w, 1e-5)
