"""The port's Llama paged serving steps against the JAX package, on the
CPU, in fp32, from the same (converted) params.

``paged_prefill_chunk``, ``paged_decode_step`` and ``paged_verify_step``
must give the JAX logits within atol 1e-4 (fp32; sums in another order)
and leave the same K/V in every pool block but the null block (its
contents are garbage by design: colliding writes land there).  Both GQA
(group 2) and MHA (group 1) configs.
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402

ATOL = 1e-4
BS, NB, MB = 4, 12, 5


def _pair(kv):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, n_kv_heads=kv,
                               remat="none")
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, n_kv_heads=kv)
    jp = jl.init_params(jax.random.PRNGKey(kv), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu", dtype=torch.float32)
    shape = (jcfg.n_layers, NB, BS, kv, jcfg.head_dim)
    jpool = {"k": jnp.zeros(shape, jnp.float32),
             "v": jnp.zeros(shape, jnp.float32)}
    tpool = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    return jcfg, tcfg, jp, tp, jpool, tpool


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_pools(jpool, tpool):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tpool[name])[:, 1:], _np(jpool[name])[:, 1:],
            atol=ATOL, rtol=0,
        )


TABLE_A = np.array([1, 2, 3, 4, 0], np.int32)
TABLE_B = np.array([5, 6, 7, 0, 0], np.int32)


def _prefill_both(kv, rng):
    """Two sequences prefilled in chunks (A: 6 + 6 tokens, the second
    chunk padded; B: 7 tokens), each compared as it goes."""
    jcfg, tcfg, jp, tp, jpool, tpool = _pair(kv)
    seq_a = rng.integers(1, 256, 10).astype(np.int32)
    seq_b = rng.integers(1, 256, 7).astype(np.int32)
    chunks = [
        (seq_a[:6], TABLE_A, 0),
        (np.pad(seq_a[6:], (0, 2)), TABLE_A, 6),
        (np.pad(seq_b, (0, 0)), TABLE_B, 0),
    ]
    for toks, table, start in chunks:
        jl_logits, jpool = jl.paged_prefill_chunk(
            jp, jnp.asarray(toks[None]), jpool, jnp.asarray(table),
            jnp.int32(start), jcfg)
        tl_logits, tpool = tl.paged_prefill_chunk(
            tp, torch.from_numpy(toks[None].copy()), tpool,
            torch.from_numpy(table.copy()), start, tcfg)
        assert tl_logits.dtype == torch.float32
        assert tl_logits.shape == (1, toks.size, tcfg.vocab_size)
        np.testing.assert_allclose(
            _np(tl_logits), _np(jl_logits), atol=ATOL, rtol=0)
    _assert_pools(jpool, tpool)
    return jcfg, tcfg, jp, tp, jpool, tpool


def _lanes():
    tables = np.stack([TABLE_A, TABLE_B, np.zeros(MB, np.int32)])
    active = np.array([True, True, False])
    return tables, active


@pytest.mark.parametrize("kv", [2, 4])
def test_prefill_chunks_match_jax(kv):
    _prefill_both(kv, np.random.default_rng(10 + kv))


@pytest.mark.parametrize("kv", [2, 4])
def test_decode_step_matches_jax(kv):
    rng = np.random.default_rng(20 + kv)
    jcfg, tcfg, jp, tp, jpool, tpool = _prefill_both(kv, rng)
    tables, active = _lanes()
    for positions in (np.array([10, 7, 3], np.int32),
                      np.array([11, 8, 0], np.int32)):
        tokens = rng.integers(1, 256, 3).astype(np.int32)
        jlog, jpool = jl.paged_decode_step(
            jp, jnp.asarray(tokens), jpool, jnp.asarray(tables),
            jnp.asarray(positions), jnp.asarray(active), jcfg)
        tlog, tpool = tl.paged_decode_step(
            tp, torch.from_numpy(tokens), tpool, torch.from_numpy(tables),
            torch.from_numpy(positions), torch.from_numpy(active), tcfg)
        assert tlog.shape == (3, tcfg.vocab_size)
        assert tlog.dtype == torch.float32
        # the inactive lane computes on the null block: discarded
        np.testing.assert_allclose(
            _np(tlog)[:2], _np(jlog)[:2], atol=ATOL, rtol=0)
    _assert_pools(jpool, tpool)


@pytest.mark.parametrize("kv", [2, 4])
def test_verify_step_matches_jax(kv):
    rng = np.random.default_rng(30 + kv)
    jcfg, tcfg, jp, tp, jpool, tpool = _prefill_both(kv, rng)
    tables, active = _lanes()
    positions = np.array([7, 4, 0], np.int32)
    tokens = rng.integers(1, 256, (3, 3)).astype(np.int32)
    jlog = jl.paged_verify_step(
        jp, jnp.asarray(tokens), jpool, jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(active), jcfg)
    before = {k: v.clone() for k, v in tpool.items()}
    tlog = tl.paged_verify_step(
        tp, torch.from_numpy(tokens), tpool, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(active), tcfg)
    assert tlog.shape == (3, 3, tcfg.vocab_size)
    np.testing.assert_allclose(
        _np(tlog)[:2], _np(jlog)[:2], atol=ATOL, rtol=0)
    for k in tpool:  # verify only reads the pool
        assert torch.equal(tpool[k], before[k])


@pytest.mark.parametrize("step", ["prefill", "decode", "verify"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_steps_fuse_every_residual_add_into_a_norm(step, dtype,
                                                           monkeypatch):
    """Each serving step runs layer 0's attention norm alone and every
    other norm with the residual add before it (``add_rms_norm``, 2 per
    layer: L x 2 + 1 norms, no add of their own), and gives the logits
    of the unfused sequence (the add, then the norm) bit for bit."""
    tcfg = tl.LlamaConfig.tiny(dtype=dtype)
    tp = tl.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    shape = (tcfg.n_layers, NB, BS, tcfg.n_kv_heads, tcfg.head_dim)
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(np.stack([TABLE_A, TABLE_B]))
    active = torch.tensor([True, True])
    tokens = torch.from_numpy(rng.integers(1, 256, (2, 3)).astype(np.int32))

    def run():
        pool = {k: torch.zeros(shape, dtype=dtype) for k in ("k", "v")}
        if step == "prefill":
            return tl.paged_prefill_chunk(tp, tokens[:1], pool, tables[0], 0,
                                          tcfg)[0]
        positions = torch.tensor([5, 2], dtype=torch.int32)
        if step == "decode":
            return tl.paged_decode_step(tp, tokens[:, 0], pool, tables,
                                        positions, active, tcfg)[0]
        return tl.paged_verify_step(tp, tokens, pool, tables, positions,
                                    active, tcfg)

    calls = {"rms_norm": 0, "add_rms_norm": 0}

    def counted(name, fn):
        def wrapper(*a):
            calls[name] += 1
            return fn(*a)
        return wrapper

    monkeypatch.setattr(tl, "rms_norm", counted("rms_norm", tl.rms_norm))
    monkeypatch.setattr(tl, "add_rms_norm",
                        counted("add_rms_norm", tl.add_rms_norm))
    fused_logits = run()
    assert calls == {"rms_norm": 1, "add_rms_norm": 2 * tcfg.n_layers}
    monkeypatch.setattr(tl, "add_rms_norm", lambda x, d, w, eps: (
        x + d, tl.rms_norm(x + d, w, eps)))
    assert torch.equal(fused_logits, run())


def test_decode_past_table_writes_null_block_only():
    """A draft position past a lane's table must not alias its last
    real block."""
    _, tcfg, _, tp, _, tpool = _pair(2)
    tables = torch.from_numpy(np.stack([TABLE_A]))
    before = {k: v.clone() for k, v in tpool.items()}
    tl.paged_decode_step(
        tp, torch.tensor([7], dtype=torch.int32), tpool, tables,
        torch.tensor([MB * BS + 1], dtype=torch.int32),
        torch.tensor([True]), tcfg)
    for k in tpool:
        assert torch.equal(tpool[k][:, 1:], before[k][:, 1:])
        assert not torch.equal(tpool[k][:, 0], before[k][:, 0])


def test_rope_matches_jax():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    rng = np.random.default_rng(40)
    pos = rng.integers(0, 120, 6).astype(np.int32)
    jc, js = jl.rope_frequencies(jcfg, jnp.asarray(pos))
    tc, ts = tl.rope_frequencies(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6, rtol=0)
    x = rng.standard_normal((1, 6, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.apply_rope(torch.from_numpy(x), tc, ts)),
        _np(jl.apply_rope(jnp.asarray(x), jc, js)), atol=1e-6, rtol=0)
    xr = rng.standard_normal((6, 1, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl._apply_rope_rows(torch.from_numpy(xr), tc, ts)),
        _np(jl._apply_rope_rows(jnp.asarray(xr), jc, js)),
        atol=1e-6, rtol=0)
    xg = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    cg, sg = tc.reshape(2, 3, -1), ts.reshape(2, 3, -1)
    np.testing.assert_allclose(
        _np(tl._apply_rope_grid(torch.from_numpy(xg), cg, sg)),
        _np(jl._apply_rope_grid(jnp.asarray(xg), jnp.asarray(_np(cg)),
                                jnp.asarray(_np(sg)))),
        atol=1e-6, rtol=0)


def test_params_from_jax_round_trips_shapes():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(tree, device="cpu", dtype=torch.float32)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 3 + 9
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["wq"].dtype == torch.bfloat16
    # the port's own init has the same layout
    own = tl.init_params(tl.LlamaConfig.tiny(), device="cpu")
    assert {k: tuple(v.shape) for k, v in own["layers"].items()} == {
        k: tuple(v.shape) for k, v in tp["layers"].items()}
    assert own["embed"].dtype == torch.bfloat16


def test_init_params_seeded_and_scaled():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, dim=128, mlp_dim=256)
    a = tl.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tl.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    c = tl.init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    std = float(a["layers"]["w_down"].std())
    assert abs(std - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert torch.equal(a["final_norm"], torch.ones(128))


def test_bf16_model_gives_fp32_logits():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, device="cpu")
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=torch.bfloat16),
            "v": torch.zeros(shape, dtype=torch.bfloat16)}
    logits, _ = tl.paged_decode_step(
        params, torch.tensor([3, 4], dtype=torch.int32), pool,
        torch.from_numpy(np.stack([TABLE_A, TABLE_B])),
        torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([True, True]), cfg)
    assert logits.dtype == torch.float32
    # the same product taken in fp32 from the bf16 values
    assert bool(torch.isfinite(logits).all())
