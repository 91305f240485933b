"""The port's continuous-batching scheduler against the JAX package's,
on the CPU, in fp32, from the same (converted) params.

At temperature 0 both schedulers must emit exactly the same tokens,
finish for the same reasons and leave the block pool in the same state
(``BlockPool.stats()``), for K=1 and the K=3 self-draft + verify window,
under plain mixed-length traffic, a starved pool that forces preemption
and resume, shared-prefix prompts, an EOS id, and reservation
admission.  At temperature > 0 the port draws JAX's own threefry bits
(``rl/sampling.py``), so the two schedulers emit the same tails token by
token there too, for K=1 and K=3, under mixed lengths and under
preemption and resume.  The sampler itself is held to
``jax.random.bits``, ``gumbel`` and ``categorical`` on a grid of seeds
(0, 2^31 + 5, 2^32 + 3) and positions (0 to 10^6), and to its own
contract: a tail is a pure function of (seed, position), and the sampled
frequencies match the softmax.
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.rl.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JaxScheduler,
    SchedulerConfig as JaxSchedulerConfig,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.ops import _build  # noqa: E402
from dlrover_tpu_torch.rl.sampling import (  # noqa: E402
    gumbel_noise,
    noise_bits,
    sample_tokens,
    uniform_from_bits,
)
from dlrover_tpu_torch.rl.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler,
    SchedulerConfig,
)

SIZES = dict(vocab_size=97, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
             mlp_dim=64)
JCFG = jl.LlamaConfig.tiny(remat="none", dtype=jnp.float32, **SIZES)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32, **SIZES)
JPARAMS = jl.init_params(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_jax(jax.tree_util.tree_map(np.asarray, JPARAMS),
                          device="cpu", dtype=torch.float32)

PROMPTS = [
    np.array([5, 9, 2], np.int32),
    np.array([11, 3, 7, 8, 1, 2, 9], np.int32),  # > prefill_chunk
    np.array([1, 2], np.int32),
    np.array([30, 31, 32, 33], np.int32),
]
BASE = dict(max_slots=4, block_size=4, num_blocks=64, max_seq_len=64,
            prefill_chunk=3, temperature=0.0)
STARVED = dict(BASE, num_blocks=9)
STAT_KEYS = ("iterations", "total_new_tokens", "total_prefill_tokens",
             "preemptions", "grown_blocks", "accepted_tokens",
             "lane_windows")


def _port(sched_kw, temp=None):
    kw = dict(sched_kw)
    if temp is not None:
        kw["temperature"] = temp
    sch = ContinuousBatchingScheduler(TCFG, SchedulerConfig(**kw),
                                      device="cpu")
    sch.sync_weights(TPARAMS)
    return sch


def _run_both(monkeypatch, k, sched_kw, prompts, max_new, env=(),
              temp=None):
    if temp is not None:
        sched_kw = dict(sched_kw, temperature=temp)
    monkeypatch.setenv("DLROVER_TPU_DECODE_STEPS", str(k))
    for name, value in env:
        monkeypatch.setenv(name, value)
    js = JaxScheduler(JCFG, JaxSchedulerConfig(**sched_kw))
    js.sync_weights(JPARAMS)
    ts = _port(sched_kw)
    for i, p in enumerate(prompts):
        js.submit(p, max_new=max_new, seed=50 + i)
        ts.submit(p, max_new=max_new, seed=50 + i)
    jres = {r.req_id: r for r in js.run()}
    tres = {r.req_id: r for r in ts.run()}
    assert sorted(tres) == sorted(jres) == list(range(len(prompts)))
    for rid, jr in jres.items():
        np.testing.assert_array_equal(tres[rid].tokens, jr.tokens)
        assert tres[rid].finish_reason == jr.finish_reason
        assert tres[rid].new_tokens == jr.new_tokens
    assert ts.block_pool.stats() == js.block_pool.stats()
    jst, tst = js.stats(), ts.stats()
    assert {k: tst[k] for k in STAT_KEYS} == {k: jst[k] for k in STAT_KEYS}
    assert ts.idle and tst["used_blocks"] == 0
    return jst, tst, tres


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    _build.reset_launches()
    yield
    assert all(n == 0 for n in _build.launches.values())


@pytest.mark.parametrize("k", [1, 3])
def test_greedy_tails_match_jax(monkeypatch, k):
    _, tst, _ = _run_both(monkeypatch, k, BASE, PROMPTS, max_new=6)
    assert tst["decode_steps"] == k and tst["device"] == "cpu"


@pytest.mark.parametrize("k", [1, 3])
def test_preemption_and_resume_match_jax(monkeypatch, k):
    """A pool far below worst-case demand: growth, at least one
    preemption, resume by re-prefill, and the same tails as JAX."""
    jst, tst, _ = _run_both(
        monkeypatch, k, STARVED, PROMPTS, max_new=12,
        env=(("DLROVER_TPU_KV_ADMIT_WATERMARK", "0"),
             ("DLROVER_TPU_KV_GROW_BLOCKS", "1")),
    )
    assert tst["preemptions"] >= 1 and tst["grown_blocks"] > 0


@pytest.mark.parametrize("k", [1, 3])
def test_sampled_tails_match_jax(monkeypatch, k):
    """temperature 0.8: the same tails as the JAX scheduler, token by
    token, and not the greedy ones."""
    _, _, tres = _run_both(monkeypatch, k, BASE, PROMPTS, max_new=8,
                           temp=0.8)
    greedy = _tails(_port(BASE), PROMPTS, 8, [50 + i for i in
                                               range(len(PROMPTS))])
    assert any(not np.array_equal(greedy[i], tres[i].tokens)
               for i in range(len(PROMPTS)))


@pytest.mark.parametrize("k", [1, 3])
def test_sampled_tails_under_preemption_match_jax(monkeypatch, k):
    """temperature 0.8 on the starved pool: preempted and resumed
    requests draw the JAX scheduler's tokens."""
    _, tst, _ = _run_both(
        monkeypatch, k, STARVED, PROMPTS, max_new=12,
        env=(("DLROVER_TPU_KV_ADMIT_WATERMARK", "0"),
             ("DLROVER_TPU_KV_GROW_BLOCKS", "1")), temp=0.8,
    )
    assert tst["preemptions"] >= 1


def test_shared_prefix_matches_jax(monkeypatch):
    system = np.arange(1, 17, dtype=np.int32)  # 4 full blocks
    prompts = [np.concatenate([system, np.array([40 + i, 41 + i],
                                                np.int32)])
               for i in range(3)]
    _, tst, _ = _run_both(
        monkeypatch, 1, dict(BASE, max_slots=1), prompts, max_new=4)
    assert tst["prefix_hits"] > 0


def test_eos_matches_jax(monkeypatch):
    probe = _port(BASE)
    probe.submit(PROMPTS[0], max_new=6, seed=50)
    eos = int(probe.run()[0].tokens[PROMPTS[0].size + 1])
    _, _, tres = _run_both(
        monkeypatch, 1, dict(BASE, eos_id=eos), PROMPTS, max_new=6)
    assert tres[0].finish_reason == "eos" and tres[0].tokens[-1] == eos


def test_reservation_admission_matches_jax(monkeypatch):
    _, tst, _ = _run_both(
        monkeypatch, 1, dict(BASE, max_slots=2, num_blocks=8), PROMPTS,
        max_new=6, env=(("DLROVER_TPU_KV_INCREMENTAL", "0"),),
    )
    assert tst["incremental"] == 0 and tst["prefix_queries"] == 0


# ------------------------------------------------ sampling contract


def _tails(sch, prompts, max_new, seeds):
    for p, s in zip(prompts, seeds):
        sch.submit(p, max_new=max_new, seed=s)
    return {r.req_id: r.tokens for r in sch.run()}


def test_sampled_tail_is_pure_function_of_seed_and_position(monkeypatch):
    """temp 0.8: the same request's tail alone, batched with others,
    and batched on a starved pool that preempts it, is identical."""
    monkeypatch.setenv("DLROVER_TPU_KV_ADMIT_WATERMARK", "0")
    monkeypatch.setenv("DLROVER_TPU_KV_GROW_BLOCKS", "1")
    seeds = [50 + i for i in range(len(PROMPTS))]
    batched = _tails(_port(BASE, 0.8), PROMPTS, 12, seeds)
    starved_sch = _port(STARVED, 0.8)
    starved = _tails(starved_sch, PROMPTS, 12, seeds)
    assert starved_sch.stats()["preemptions"] >= 1
    for i, p in enumerate(PROMPTS):
        alone = _tails(_port(BASE, 0.8), [p], 12, [seeds[i]])[0]
        np.testing.assert_array_equal(batched[i], alone)
        np.testing.assert_array_equal(starved[i], alone)
    greedy = _tails(_port(BASE, 0.0), PROMPTS, 12, seeds)
    assert any(not np.array_equal(greedy[i], batched[i])
               for i in range(len(PROMPTS)))


def test_sampler_frequencies_match_softmax():
    """Gumbel-max over the hash noise samples softmax(logits / T): over
    40000 (seed, position) draws at vocab 8, every token's frequency is
    within 0.01 of its probability (4 standard errors at p = 0.5)."""
    temp = 0.7
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5, 0.2])
    n = 40000
    seeds = torch.arange(n)
    positions = torch.arange(n) % 97 + 3
    toks = sample_tokens(logits.expand(n, 8), seeds, positions, temp)
    freq = torch.bincount(toks.long(), minlength=8).float() / n
    prob = torch.softmax(logits / temp, dim=-1)
    assert float((freq - prob).abs().max()) < 0.01
    # one seed walking many positions draws the same distribution
    toks = sample_tokens(logits.expand(n, 8), torch.tensor(7),
                         torch.arange(n), temp)
    freq = torch.bincount(toks.long(), minlength=8).float() / n
    assert float((freq - prob).abs().max()) < 0.01


def test_sampler_is_batch_independent():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((5, 3, 11)).astype(
        np.float32))
    seeds = torch.tensor([4, 9, 4, 1, 2])[:, None]
    pos = torch.tensor([[3, 4, 5]]) + torch.arange(5)[:, None]
    grid = sample_tokens(logits, seeds, pos, 1.0)
    assert grid.shape == (5, 3) and grid.dtype == torch.int32
    for b in range(5):
        for c in range(3):
            one = sample_tokens(logits[b, c], seeds[b, 0], pos[b, c], 1.0)
            assert int(one) == int(grid[b, c])
    u = uniform_from_bits(noise_bits(torch.tensor(1), torch.tensor(2), 1000))
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert torch.equal(sample_tokens(logits, seeds, pos, 0.0),
                       logits.argmax(-1).to(torch.int32))


SEEDS = [0, 2**31 + 5, 2**32 + 3]
POSITIONS = [0, 7, 10**6]


def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(seed), pos)


@pytest.mark.parametrize("vocab", [97, 32000])
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_noise_bits_equal_jax_random_bits(seed, pos, vocab):
    want = np.asarray(jax.random.bits(_jax_key(seed, pos), (vocab,),
                                      jnp.uint32)).astype(np.int64)
    got = noise_bits(torch.tensor(seed), torch.tensor(pos), vocab)
    assert got.dtype == torch.int64 and got.shape == (vocab,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_matches_jax(seed):
    """fp32 Gumbel noise within 1e-6 relative (and 1e-6 absolute where
    it crosses 0): only the two libraries' ``log`` may differ."""
    seeds = torch.tensor(seed)[None].expand(3)
    pos = torch.tensor(POSITIONS)
    got = gumbel_noise(seeds[:, None], pos[:, None], 32000)
    assert got.shape == (3, 1, 32000) and got.dtype == torch.float32
    for i, p in enumerate(POSITIONS):
        want = np.asarray(jax.random.gumbel(_jax_key(seed, p), (32000,)))
        np.testing.assert_allclose(got[i, 0].numpy(), want, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("temp", [0.8, 1.0, 1.7])
@pytest.mark.parametrize("vocab", [97, 32000])
def test_sample_tokens_equal_jax_categorical(vocab, temp):
    """The reference's ``_sample_grid`` (jitted, vmapped ``fold_in`` and
    ``categorical(key, logits / T)``) against ``sample_tokens`` over a
    [seeds x positions] grid."""
    rng = np.random.default_rng(vocab)
    logits = (3 * rng.standard_normal((3, 3, vocab))).astype(np.float32)
    seeds = np.array(SEEDS)
    pos = np.array([POSITIONS] * 3, np.int32)
    keys = np.stack([np.asarray(jax.random.key_data(
        jax.random.PRNGKey(int(s)))) for s in seeds])

    @jax.jit
    def grid(logits, keys, pos):
        folded = jax.vmap(lambda k, ps: jax.vmap(
            lambda p: jax.random.fold_in(k, p))(ps))(keys, pos)
        return jax.vmap(jax.vmap(
            lambda k, l: jax.random.categorical(k, l / temp)))(
                folded, logits)

    want = np.asarray(grid(logits, keys, pos))
    got = sample_tokens(torch.from_numpy(logits),
                        torch.tensor(SEEDS)[:, None],
                        torch.from_numpy(pos), temp)
    np.testing.assert_array_equal(got.numpy(), want)


def test_submit_validation_and_weights_first():
    sch = ContinuousBatchingScheduler(TCFG, SchedulerConfig(**BASE),
                                      device="cpu")
    with pytest.raises(ValueError, match="at least one token"):
        sch.submit(np.array([], np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        sch.submit(np.arange(60), max_new=8)
    with pytest.raises(ValueError, match="max_new"):
        sch.submit(PROMPTS[0], max_new=0)
    sch.submit(PROMPTS[0], max_new=2)
    with pytest.raises(RuntimeError, match="sync_weights"):
        sch.step()
    tiny = ContinuousBatchingScheduler(
        TCFG, SchedulerConfig(**dict(BASE, num_blocks=5)), device="cpu")
    with pytest.raises(ValueError, match="blocks > pool"):
        tiny.submit(PROMPTS[1], max_new=12)


def test_resume_tokens_continue_the_same_stream():
    """A request re-submitted with its first 3 generated tokens as the
    resume tail ends with the uninterrupted tail."""
    full = _tails(_port(BASE), [PROMPTS[1]], 8, [5])[0]
    tail = full[PROMPTS[1].size:]
    sch = _port(BASE)
    sch.submit(PROMPTS[1], max_new=8, seed=5, resume_tokens=tail[:3])
    res = sch.run()[0]
    np.testing.assert_array_equal(res.tokens, full)
