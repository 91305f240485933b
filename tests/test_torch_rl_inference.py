"""The port's whole-batch generators against the JAX package's, on the
CPU at ``LlamaConfig.tiny`` in fp32, from the same (converted) params.

- ``models.llama.prefill`` and three ``decode_step``s: logits and the
  K/V caches within 1e-5 of JAX's (``init_kv_cache``'s layout).
- ``rl.sampling.split`` and ``categorical`` against ``jax.random.split``
  and ``jax.random.categorical`` over a ``[B, V]`` block from one key:
  the keys and the threefry bits equal, the tokens equal.
- ``ModelEngine.make_sampler``, ``JitSamplerBackend`` and
  ``KVCacheBackend``: the same tokens as JAX's for the same
  ``PRNGKey``, at T 0 and T 1.0; the cached decoder equals the
  full-forward sampler greedily (``tests/test_rlhf.py``'s contract);
  the one-token-at-a-time prefill equals the batched one; bucketed
  prompts equal exact ones at T 0 and 1 (``TestShapeBuckets`` in
  ``tests/test_serving.py``, without the compile counts: the port
  compiles nothing).

Every run is on the CPU, so no kernel launches (checked per test).
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.rl.engine import ModelEngine as JaxEngine  # noqa: E402
from dlrover_tpu.rl.inference import (  # noqa: E402
    JitSamplerBackend as JaxJitSampler,
    KVCacheBackend as JaxKVCache,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.ops import _build  # noqa: E402
from dlrover_tpu_torch.rl import sampling  # noqa: E402
from dlrover_tpu_torch.rl.engine import ModelEngine  # noqa: E402
from dlrover_tpu_torch.rl.inference import (  # noqa: E402
    JitSamplerBackend,
    KVCacheBackend,
    bucket_len,
)

JCFG = jl.LlamaConfig.tiny(remat="none", dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(remat="none", dtype=torch.float32)
JPARAMS = jl.init_params(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_jax(jax.tree_util.tree_map(np.asarray, JPARAMS),
                          device="cpu", dtype=None)
# logits and caches: fp32 products of the same numbers in another order
ATOL = 1e-5
MAX_NEW = 6
PROMPTS = np.random.default_rng(0).integers(0, 256, (3, 5)).astype(np.int32)


def jax_forward(params, tokens):
    return jl.forward(params, tokens, JCFG)


def torch_forward(params, tokens):
    return tl.forward(params, tokens, TCFG)


def key_of(jkey):
    return np.asarray(jkey)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    _build.reset_launches()
    yield
    assert all(n == 0 for n in _build.launches.values())


@pytest.fixture(scope="module")
def jax_tokens():
    """JAX's generations, once per module: ``{(backend, T): tokens}`` for
    ``PROMPTS`` and ``PRNGKey(1)``."""
    key = jax.random.PRNGKey(1)
    prompts = jnp.asarray(PROMPTS)
    out = {}
    for temp in (0.0, 1.0):
        kv = JaxKVCache(JCFG, max_new_tokens=MAX_NEW, temperature=temp)
        out["kv", temp] = np.asarray(kv.generate(prompts, key, JPARAMS))
        full = JaxJitSampler(jax_forward, MAX_NEW, temperature=temp)
        out["full", temp] = np.asarray(full.generate(prompts, key, JPARAMS))
        sample = JaxEngine.make_sampler(jax_forward, MAX_NEW, temp)
        out["sampler", temp] = np.asarray(sample(JPARAMS, prompts, key))
    return out


# ------------------------------------------------ the dense-cache steps


def test_prefill_and_decode_steps_match_jax():
    b, p, total = 2, 5, 9
    toks = PROMPTS[:b]
    jc = jl.init_kv_cache(JCFG, b, total)
    jlog, jc = jl.prefill(JPARAMS, jnp.asarray(toks), jc, JCFG)
    tc = tl.init_kv_cache(TCFG, b, total, device="cpu")
    assert tc["k"].shape == (TCFG.n_layers, b, total, TCFG.n_kv_heads,
                             TCFG.head_dim)
    assert tc["k"].dtype == tc["v"].dtype == torch.float32
    tlog, tc2 = tl.prefill(TPARAMS, torch.from_numpy(toks), tc, TCFG)
    assert tc2 is tc  # written in place
    assert tlog.dtype == torch.float32 and tlog.shape == (b, p, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    for i, t in enumerate((3, 7, 11)):
        pos = p + i
        jlg, jc = jl.decode_step(JPARAMS, jnp.full((b,), t, jnp.int32), jc,
                                 jnp.int32(pos), JCFG)
        tlg, tc = tl.decode_step(TPARAMS,
                                 torch.full((b,), t, dtype=torch.int32),
                                 tc, pos, TCFG)
        assert tlg.shape == (b, 256) and tlg.dtype == torch.float32
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=ATOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=ATOL)


def test_decode_equals_full_forward_at_every_position():
    """The cache is the forward: prefill plus decode of the rest gives
    ``forward``'s logits at each position."""
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 10)).astype(np.int32))
    full = tl.forward(TPARAMS, toks, TCFG).detach()
    cache = tl.init_kv_cache(TCFG, 2, 10, device="cpu")
    logits, cache = tl.prefill(TPARAMS, toks[:, :4], cache, TCFG)
    got = [logits[:, i] for i in range(4)]
    for pos in range(4, 10):
        step, cache = tl.decode_step(TPARAMS, toks[:, pos], cache, pos,
                                     TCFG)
        got.append(step)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               atol=ATOL)


def test_bf16_cache_and_fp32_master_weights():
    """``cfg.dtype`` bf16 on fp32 weights: bf16 cache, fp32 logits, and
    the prefill within bf16 rounding of JAX's."""
    jcfg = jl.LlamaConfig.tiny(remat="none")
    tcfg = tl.LlamaConfig.tiny(remat="none")
    toks = PROMPTS[:2]
    jc = jl.init_kv_cache(jcfg, 2, 8)
    jlog, jc = jl.prefill(JPARAMS, jnp.asarray(toks), jc, jcfg)
    tc = tl.init_kv_cache(tcfg, 2, 8, device="cpu")
    tlog, tc = tl.prefill(TPARAMS, torch.from_numpy(toks), tc, tcfg)
    assert tc["k"].dtype == torch.bfloat16 and tlog.dtype == torch.float32
    err = np.abs(tlog.numpy() - np.asarray(jlog)).max()
    assert err < 0.05 * np.abs(np.asarray(jlog)).max(), err


# ----------------------------------------------------- the batch sampler


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5, 2 ** 32 + 3])
def test_split_equals_jax_random_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = sampling.prng_key(seed)
    assert tk == tuple(int(w) for w in np.asarray(jk))
    for _ in range(3):
        ja, jb = jax.random.split(jk)
        ta, tb = sampling.split(tk)
        assert ta == tuple(int(w) for w in np.asarray(ja))
        assert tb == tuple(int(w) for w in np.asarray(jb))
        jk, tk = ja, ta
    four = sampling.split(tk, 4)
    assert four == [tuple(int(w) for w in row)
                    for row in np.asarray(jax.random.split(jk, 4))]


@pytest.mark.parametrize("shape", [(1, 97), (3, 256), (8, 1000)])
def test_key_bits_equal_jax_random_bits(shape):
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = sampling.key_bits(key_of(key), shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("temp", [1.0, 0.7, 1.3])
@pytest.mark.parametrize("shape", [(3, 97), (8, 256)])
def test_categorical_equals_jax_categorical(temp, shape):
    """One key over the whole ``[B, V]`` block, as the generators draw."""
    logits = np.random.default_rng(11).standard_normal(shape).astype(
        np.float32) * 3
    draw = jax.jit(lambda k, lg: jax.random.categorical(k, lg / temp,
                                                        axis=-1))
    key = jax.random.PRNGKey(0)
    for _ in range(4):
        key, sub = jax.random.split(key)
        want = np.asarray(draw(sub, logits))
        got = sampling.categorical(key_of(sub), torch.from_numpy(logits),
                                   temp)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_key_words_reads_seeds_words_and_tensors():
    assert sampling.key_words(5) == (0, 5)
    assert sampling.key_words(np.int64(2 ** 32 + 3)) == (0, 3)
    jk = jax.random.PRNGKey(9)
    words = tuple(int(w) for w in np.asarray(jk))
    assert sampling.key_words(np.asarray(jk)) == words
    assert sampling.key_words(torch.tensor(words)) == words
    assert sampling.key_words(list(words)) == words
    with pytest.raises(ValueError, match="two uint32 words"):
        sampling.key_words([1, 2, 3])


# ------------------------------------------------------- the generators


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_make_sampler_tokens_equal_jax(jax_tokens, temp):
    sample = ModelEngine.make_sampler(torch_forward, MAX_NEW, temp)
    out = sample(TPARAMS, torch.from_numpy(PROMPTS),
                 key_of(jax.random.PRNGKey(1)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), jax_tokens["sampler", temp])


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_jit_sampler_backend_tokens_equal_jax(jax_tokens, temp):
    backend = JitSamplerBackend(torch_forward, MAX_NEW, temperature=temp,
                                device="cpu")
    backend.sync_weights(TPARAMS)
    out = backend.generate(PROMPTS, key_of(jax.random.PRNGKey(1)))
    np.testing.assert_array_equal(out.numpy(), jax_tokens["full", temp])


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_kv_cache_backend_tokens_equal_jax(jax_tokens, temp):
    backend = KVCacheBackend(TCFG, max_new_tokens=MAX_NEW, temperature=temp,
                             device="cpu")
    out = backend.generate(PROMPTS, key_of(jax.random.PRNGKey(1)), TPARAMS)
    assert out.dtype == torch.int32 and out.shape == (3, 5 + MAX_NEW)
    np.testing.assert_array_equal(out.numpy()[:, :5], PROMPTS)
    np.testing.assert_array_equal(out.numpy(), jax_tokens["kv", temp])


def test_kv_cache_greedy_matches_full_forward_sampler():
    """Cached decode generates the full-forward sampler's tokens
    greedily (``tests/test_rlhf.py::TestKVCacheBackend``)."""
    prompts = np.array([[5, 7, 11, 13], [2, 3, 4, 5]], np.int32)
    full = JitSamplerBackend(torch_forward, 6, temperature=0.0,
                             device="cpu")
    cached = KVCacheBackend(TCFG, 6, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(
        cached.generate(prompts, 1, TPARAMS).numpy(),
        full.generate(prompts, 1, TPARAMS).numpy())


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_scan_prefill_equals_batched(monkeypatch, jax_tokens, temp):
    key = key_of(jax.random.PRNGKey(1))
    monkeypatch.setenv("DLROVER_TPU_GEN_BATCHED_PREFILL", "0")
    scan = KVCacheBackend(TCFG, MAX_NEW, temperature=temp, device="cpu")
    assert scan._prefill is None
    np.testing.assert_array_equal(
        scan.generate(PROMPTS, key, TPARAMS).numpy(),
        jax_tokens["kv", temp])
    # a model with no prefill fn takes the same path
    monkeypatch.delenv("DLROVER_TPU_GEN_BATCHED_PREFILL")
    own = KVCacheBackend(
        TCFG, MAX_NEW, temperature=temp, device="cpu",
        decode_step_fn=lambda p, t, c, pos: tl.decode_step(p, t, c, pos,
                                                           TCFG),
        init_cache_fn=lambda b, n: tl.init_kv_cache(TCFG, b, n, "cpu"))
    assert own._prefill is None
    np.testing.assert_array_equal(
        own.generate(PROMPTS, key, TPARAMS).numpy(),
        jax_tokens["kv", temp])


def test_bucket_len():
    assert bucket_len(3, (8, 16)) == 8
    assert bucket_len(8, (8, 16)) == 8
    assert bucket_len(11, (8, 16)) == 16
    assert bucket_len(20, (8, 16)) == 20
    assert bucket_len(5, ()) == 5


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("kind", ["kv", "full"])
def test_bucketed_equals_exact(monkeypatch, kind, temp):
    """Prompts padded to a bucket give the exact-shape tokens (the batch
    dim is never padded, so the noise is the same)."""
    def make():
        if kind == "kv":
            return KVCacheBackend(TCFG, 4, temperature=temp, device="cpu")
        return JitSamplerBackend(torch_forward, 4, temperature=temp,
                                 device="cpu")

    key = key_of(jax.random.PRNGKey(1))
    gen = np.random.default_rng(3)
    prompts = {plen: gen.integers(0, 97, (2, plen)).astype(np.int32)
               for plen in (3, 5, 8, 11)}
    monkeypatch.delenv("DLROVER_TPU_GEN_BUCKETS", raising=False)
    exact = make()
    want = {plen: exact.generate(p, key, TPARAMS).numpy()
            for plen, p in prompts.items()}
    monkeypatch.setenv("DLROVER_TPU_GEN_BUCKETS", "8,16")
    bucketed = make()
    for plen, p in prompts.items():
        out = bucketed.generate(p, key, TPARAMS)
        assert out.shape == (2, plen + 4)
        np.testing.assert_array_equal(out.numpy(), want[plen])


def test_sync_weights_holds_a_reference_and_sees_in_place_updates():
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, JPARAMS),
                             device="cpu", dtype=None)
    backend = KVCacheBackend(TCFG, 4, temperature=0.0, device="cpu")
    backend.sync_weights(params)
    assert backend._params is params
    before = backend.generate(PROMPTS, 0).numpy()
    with torch.no_grad():
        params["lm_head"].mul_(-1.0)  # an in-place update
    after = backend.generate(PROMPTS, 0).numpy()
    np.testing.assert_array_equal(
        after, KVCacheBackend(TCFG, 4, temperature=0.0, device="cpu")
        .generate(PROMPTS, 0, params).numpy())
    assert (after[:, 5:] != before[:, 5:]).any()
