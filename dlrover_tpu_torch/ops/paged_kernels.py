"""Paged decode and K-step verify attention: the split-KV CUDA kernels of
``ops/csrc/paged_attention.cu`` (``dl_paged_decode``, ``dl_paged_verify``)
and their plain PyTorch versions.

Port of ``dlrover_tpu/ops/paged_kernels.py:128-452``
(``paged_decode_kernel``, ``paged_verify_kernel``).  Layouts are the
JAX package's: ``q [B, H, D]`` (decode) or ``[B, C, H, D]`` (verify),
one layer's pools ``[num_blocks, block_size, KV, D]``, tables
``[B, max_blocks]`` int32.  Block 0 is the null block; its contents and
those of any page past a lane's end are garbage and never reach the
output.

The plain versions follow the kernel's numerics: fp32 logits, fp32
``p @ v`` and one cast at the end, masked keys excluded (their V rows
are zeroed, so a NaN there cannot poison the product), and a lane with
no visible key returns exact zeros.
"""

import ctypes

import torch

from dlrover_tpu_torch.ops import _build


def gather_pool(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """``[N, bs, KV, D]`` gathered by ``[B, MB]`` -> ``[B, MB*bs, KV, D]``."""
    g = pool[tables.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _masked_weights(logits, visible):
    """``logits [..., T]`` fp32 and a broadcastable ``visible`` mask ->
    unnormalised weights ``p`` (exactly 0 where masked) and their sum
    clamped at 1e-30, so a row with no visible key comes out 0."""
    logits = logits.masked_fill(~visible, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return p, denom


def paged_decode_plain(q, k_pool, v_pool, block_tables, seq_lens):
    """One query token per lane over its paged prefix: key ``t`` is
    visible iff ``t < seq_lens[b]``.  Returns ``[B, H, D]`` in
    ``q.dtype``."""
    b, nh, d = q.shape
    nkv = k_pool.shape[2]
    g = nh // nkv
    k = gather_pool(k_pool, block_tables).float()  # [B, T, KV, D]
    v = gather_pool(v_pool, block_tables).float()
    t = k.shape[1]
    cols = torch.arange(t, device=q.device)
    valid = cols[None] < seq_lens.long()[:, None]  # [B, T]
    v = v.masked_fill(~valid[:, :, None, None], 0.0)
    qg = q.float().reshape(b, nkv, g, d)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k) * (d ** -0.5)
    p, denom = _masked_weights(logits, valid[:, None, None])
    out = torch.einsum("bkgt,btkd->bkgd", p, v) / denom
    return out.to(q.dtype).reshape(b, nh, d)


def paged_verify_plain(q, k_pool, v_pool, block_tables, positions):
    """A window of ``C`` queries per lane: query ``c`` of lane ``b``
    sits at ``positions[b] + c`` and sees keys ``t <= positions[b] +
    c``.  Returns ``[B, C, H, D]`` in ``q.dtype``."""
    b, c, nh, d = q.shape
    nkv = k_pool.shape[2]
    g = nh // nkv
    k = gather_pool(k_pool, block_tables).float()
    v = gather_pool(v_pool, block_tables).float()
    t = k.shape[1]
    cols = torch.arange(t, device=q.device)
    q_pos = positions.long()[:, None] + torch.arange(c, device=q.device)
    visible = cols[None, None] <= q_pos[:, :, None]  # [B, C, T]
    # a key past the horizon is garbage for every row of the window
    v = v.masked_fill(~visible[:, -1, :, None, None], 0.0)
    qg = q.float().reshape(b, c, nkv, g, d)
    logits = torch.einsum("bckgd,btkd->bckgt", qg, k) * (d ** -0.5)
    p, denom = _masked_weights(logits, visible[:, :, None, None])
    out = torch.einsum("bckgt,btkd->bckgd", p, v) / denom
    return out.to(q.dtype).reshape(b, c, nh, d)


#: ``dl_paged_decode(q, k_pool, v_pool, out, tables, seq_lens, ws_m,
#: ws_l, ws_acc, B, H, KV, D, bs, MB, pages, scale, dtype, stream)``
DECODE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]

#: ``dl_paged_decode_smem(dtype, D, pages)``
DECODE_SMEM_ARGTYPES = [ctypes.c_int] * 3

#: ``dl_paged_verify(q, k_pool, v_pool, out, tables, positions, ws_m,
#: ws_l, ws_acc, B, C, H, KV, D, bs, MB, pages, scale, dtype, stream)``
VERIFY_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]

#: ``dl_paged_verify_smem(dtype, D, rows, pages)``
VERIFY_SMEM_ARGTYPES = [ctypes.c_int] * 4

#: Keys per split of both kernels, rounded down to whole pages (at least
#: one page).
SPLIT_KEYS = 128

#: The head dims both kernels take.
HEAD_DIMS = (16, 32, 64, 128, 256)


def verify_plan(batch, rows, kv, max_blocks, block_size):
    """Sizing of the split-KV verify kernel from shapes alone (the host
    never reads the positions): ``(pages per split, splits, workspace
    shape)``.  Each lane's table of ``max_blocks`` pages is cut into
    ``splits`` splits of ``pages`` pages; the fp32 workspace holds each
    split's running max and sum per row, ``[batch, kv, splits, rows]``
    (``rows = C * H / KV``), and its accumulator, that shape plus
    ``head_dim``."""
    pages = max(1, SPLIT_KEYS // block_size)
    splits = -(-max_blocks // pages)
    return pages, splits, (batch, kv, splits, rows)


def decode_plan(batch, heads, kv, max_blocks, block_size):
    """Sizing of the split-KV decode kernel: ``verify_plan`` with the
    ``heads / kv`` query rows of one KV head (one row at MHA)."""
    return verify_plan(batch, heads // kv, kv, max_blocks, block_size)


def _check_inputs(q, k_pool, v_pool, block_tables, lens, what):
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes fp32/bf16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what} kernel needs q and pools in one dtype")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what} kernel needs pools [N, bs, KV, D]")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{what} kernel needs int32 tables and lengths")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous {name}")
    _, bs, nkv, d = k_pool.shape
    if q.shape[-1] != d or q.shape[-2] % nkv:
        raise ValueError(
            f"{what}: q {tuple(q.shape)} does not fit pools "
            f"{tuple(k_pool.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim 16/32/64/128/256")
    # both kernels copy the pools' rows 16 bytes at a time (cp.async)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError(f"{what} kernel needs 16-byte aligned rows")
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: tables must be [B, max_blocks]")
    if lens.shape != (q.shape[0],):
        raise ValueError(f"{what}: lengths/positions must be [B]")


def _workspace(q, shape, d):
    """The fp32 partials of the splits: running max and sum, and the
    unnormalised sums ``[..., d]``."""
    ws_m = torch.empty(shape, dtype=torch.float32, device=q.device)
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty(*shape, d, dtype=torch.float32, device=q.device)
    return ws_m, ws_l, ws_acc


def _launch_decode(q, k_pool, v_pool, block_tables, seq_lens):
    what = "paged_decode"
    _check_inputs(q, k_pool, v_pool, block_tables, seq_lens, what)
    out = torch.empty_like(q)
    b, nh, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    if b == 0:
        return out
    pages, _, shape = decode_plan(b, nh, nkv, mb, bs)
    ws = _workspace(q, shape, d)
    lib = _build.library("paged_attention")
    fn = lib.dl_paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = DECODE_ARGTYPES
    code = fn(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(out), _build.ptr(block_tables), _build.ptr(seq_lens),
        *(_build.ptr(t) for t in ws), b, nh, nkv, d, bs, mb, pages,
        float(d ** -0.5), _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
    )
    _build.check(code, lib, what)
    _build.launches[what] += 1
    return out


def _launch_verify(q, k_pool, v_pool, block_tables, positions):
    what = "paged_verify"
    _check_inputs(q, k_pool, v_pool, block_tables, positions, what)
    out = torch.empty_like(q)
    b, c, nh, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    if b == 0:
        return out
    pages, _, shape = verify_plan(b, c * (nh // nkv), nkv, mb, bs)
    ws_m, ws_l, ws_acc = _workspace(q, shape, d)
    lib = _build.library("paged_attention")
    fn = lib.dl_paged_verify
    fn.restype = ctypes.c_int
    fn.argtypes = VERIFY_ARGTYPES
    code = fn(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(out), _build.ptr(block_tables), _build.ptr(positions),
        _build.ptr(ws_m), _build.ptr(ws_l), _build.ptr(ws_acc),
        b, c, nh, nkv, d, bs, mb, pages, float(d ** -0.5),
        _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
    )
    _build.check(code, lib, what)
    _build.launches[what] += 1
    return out


def decode_smem_bytes(dtype, d, pages):
    """Dynamic shared memory of one decode block at ``pages`` pages per
    split, as the launch asks for it (builds the library)."""
    fn = _build.library("paged_attention").dl_paged_decode_smem
    fn.restype = ctypes.c_int
    fn.argtypes = DECODE_SMEM_ARGTYPES
    return fn(_build.DTYPE_CODES[dtype], d, pages)


def verify_smem_bytes(dtype, d, rows, pages):
    """Dynamic shared memory of one verify block at ``rows`` query rows
    and ``pages`` pages per split, as the launch asks for it (builds the
    library)."""
    fn = _build.library("paged_attention").dl_paged_verify_smem
    fn.restype = ctypes.c_int
    fn.argtypes = VERIFY_SMEM_ARGTYPES
    return fn(_build.DTYPE_CODES[dtype], d, rows, pages)


def paged_decode_kernel(q, k_pool, v_pool, block_tables, seq_lens):
    """Paged GQA decode attention, ``q [B, H, D]`` -> ``[B, H, D]``: the
    split-KV CUDA kernel (a pass per split of the lane's pages, then a
    merge of the splits) for CUDA tensors, the plain version for CPU
    tensors."""
    if _build.on_cpu(q, k_pool, v_pool, block_tables, seq_lens):
        return paged_decode_plain(q, k_pool, v_pool, block_tables, seq_lens)
    return _launch_decode(q, k_pool, v_pool, block_tables, seq_lens)


def paged_verify_kernel(q, k_pool, v_pool, block_tables, positions):
    """Fused K-step verify, ``q [B, C, H, D]`` -> ``[B, C, H, D]``: one
    paged-prefix pass serves every window position of a lane.  The
    split-KV CUDA kernel (a pass per split of the lane's pages, then a
    merge of the splits) for CUDA tensors, the plain version for CPU
    tensors."""
    if _build.on_cpu(q, k_pool, v_pool, block_tables, positions):
        return paged_verify_plain(
            q, k_pool, v_pool, block_tables, positions
        )
    return _launch_verify(q, k_pool, v_pool, block_tables, positions)
