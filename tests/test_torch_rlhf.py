"""The port's in-process RLHF loop against the JAX package's, on the CPU
at ``LlamaConfig.tiny`` in fp32.

- ``RLConfig.from_dict`` field by field; ``compute_gae`` alone and
  batched over rows; ``ppo_loss``'s five outputs with ratios past the
  clip; ``ReplayBuffer``'s minibatch rows and order; ``token_logprobs``,
  ``actor_ppo_loss`` and ``critic_value_loss`` and their gradients
  against ``jax.grad``.
- The slice as a whole: ``RLHFTrainer.train``, two rounds, the JAX roles
  built on one device and their initial params carried into the port's
  roles (``ModelEngine.set_role_params``), Adam on both sides from zero
  moments.  The rollouts' tokens are equal, the history and the final
  actor params agree within the stated limits, and the frozen reference
  copy does not move.
- ``experience_from_trajectories`` against JAX's on the same duck-typed
  trajectories: with every captured logprob finite the actor's logprob
  forward is not run; with one NaN it runs once for the whole batch.

The JAX side is computed once per module (module-scoped fixtures).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.rl import ppo as jppo  # noqa: E402
from dlrover_tpu.rl import trainer as jtrainer  # noqa: E402
from dlrover_tpu.rl.config import RLConfig as JaxRLConfig  # noqa: E402
from dlrover_tpu.rl.engine import ModelEngine as JaxEngine  # noqa: E402
from dlrover_tpu.rl.inference import (  # noqa: E402
    KVCacheBackend as JaxKVCache,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.ops import _build  # noqa: E402
from dlrover_tpu_torch.rl import ppo as tppo  # noqa: E402
from dlrover_tpu_torch.rl import trainer as ttrainer  # noqa: E402
from dlrover_tpu_torch.rl.config import RLConfig  # noqa: E402
from dlrover_tpu_torch.rl.engine import ModelEngine  # noqa: E402
from dlrover_tpu_torch.rl.inference import KVCacheBackend  # noqa: E402

JCFG = jl.LlamaConfig.tiny(remat="none", dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(remat="none", dtype=torch.float32)
V, E = 256, 16  # vocab, the critic's embedding width
RAW = {
    "roles": {
        "actor": {"strategy": {"data": 1, "remat": "none"}},
        "critic": {"strategy": {"data": 1, "remat": "none"}},
    },
    "ppo": {"rollout_batch": 4, "ppo_epochs": 1},
}
PROMPT_LEN, MAX_NEW, BATCH, ROUNDS = 4, 4, 8, 2
# fp32 values of the same math in another order
ATOL = 1e-5


def reward_fn(tokens):
    return np.asarray(np.asarray(tokens)[:, -1] % 2 == 0, np.float32)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix: np.asarray(tree)}


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    _build.reset_launches()
    yield
    assert all(n == 0 for n in _build.launches.values())


# ------------------------------------------------------------- the roles


def jax_forward(p, t):
    return jl.forward(p, t, JCFG)


def jax_critic(p, t):
    return jnp.einsum("bse,e->bs", p["emb"][t], p["w"])


def torch_forward(p, t):
    return tl.forward(p, t, TCFG)


def torch_critic(p, t):
    return torch.einsum("bse,e->bs", p["emb"][t.long()], p["w"])


def jax_engine():
    engine = JaxEngine(JaxRLConfig.from_dict(RAW))
    one = jax.devices()[:1]
    engine.build_role(
        "actor",
        loss_fn=lambda p, b: jtrainer.actor_ppo_loss(
            jax_forward(p, b["tokens"]), b),
        optimizer=optax.adam(1e-4),
        init_params_fn=lambda rng: jl.init_params(rng, JCFG),
        param_axes=jl.param_logical_axes(JCFG), devices=one)

    def critic_init(rng):
        return {"emb": jax.random.normal(rng, (V, E), jnp.float32) * 0.1,
                "w": jnp.zeros((E,), jnp.float32)}

    engine.build_role(
        "critic",
        loss_fn=lambda p, b: jtrainer.critic_value_loss(
            jax_critic(p, b["tokens"]), b),
        optimizer=optax.adam(1e-3), init_params_fn=critic_init,
        param_axes={"emb": (None, None), "w": (None,)}, devices=one)
    engine.init_role_state("actor", jax.random.PRNGKey(0))
    engine.init_role_state("critic", jax.random.PRNGKey(1))
    return engine


def torch_engine(actor0, critic0):
    """The port's roles, their params set from the JAX roles' initial
    ones (numpy, fp32)."""
    engine = ModelEngine(RLConfig.from_dict(RAW))
    engine.build_role(
        "actor",
        loss_fn=lambda p, b: ttrainer.actor_ppo_loss(
            torch_forward(p, b["tokens"]), b),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-4),
        init_params_fn=lambda g, d: tl.init_params(TCFG, g, d,
                                                   torch.float32),
        param_axes=tl.param_logical_axes(TCFG), device="cpu")

    def critic_init(g, d):
        return {"emb": torch.randn((V, E), generator=g, device=d) * 0.1,
                "w": torch.zeros((E,), device=d)}

    engine.build_role(
        "critic",
        loss_fn=lambda p, b: ttrainer.critic_value_loss(
            torch_critic(p, b["tokens"]), b),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3),
        init_params_fn=critic_init,
        param_axes={"emb": (None, None), "w": (None,)}, device="cpu")
    engine.init_role_state("actor", 0)
    engine.init_role_state("critic", 1)
    engine.set_role_params("actor", actor0)
    engine.set_role_params("critic", critic0)
    return engine


def recording(generate, sink):
    def wrapped(prompts, rng, params=None):
        out = generate(prompts, rng, params)
        sink.append(np.asarray(out.numpy() if isinstance(out, torch.Tensor)
                               else out))
        return out
    return wrapped


PROMPTS = [np.random.default_rng(r).integers(0, V, (BATCH, PROMPT_LEN))
           .astype(np.int32) for r in range(ROUNDS)]


@pytest.fixture(scope="module")
def jax_run():
    """Two PPO rounds of the JAX package: history, rollouts, the initial
    and final params."""
    engine = jax_engine()
    actor0 = _tree_np(engine.states["actor"]["params"])
    critic0 = _tree_np(engine.states["critic"]["params"])
    backend = JaxKVCache(JCFG, max_new_tokens=MAX_NEW, temperature=1.0)
    rollouts = []
    backend.generate = recording(backend.generate, rollouts)
    trainer = jtrainer.RLHFTrainer(
        engine.config, engine, backend, jax_forward, jax_critic, reward_fn,
        prompt_len=PROMPT_LEN)
    history = trainer.train(PROMPTS, jax.random.PRNGKey(2))
    return {"history": history, "rollouts": rollouts, "actor0": actor0,
            "critic0": critic0,
            "actor": _tree_np(engine.states["actor"]["params"]),
            "critic": _tree_np(engine.states["critic"]["params"])}


@pytest.fixture(scope="module")
def port_run(jax_run):
    engine = torch_engine(jax_run["actor0"], jax_run["critic0"])
    backend = KVCacheBackend(TCFG, max_new_tokens=MAX_NEW, temperature=1.0,
                             device="cpu")
    rollouts = []
    backend.generate = recording(backend.generate, rollouts)
    trainer = ttrainer.RLHFTrainer(
        engine.config, engine, backend, torch_forward, torch_critic,
        reward_fn, prompt_len=PROMPT_LEN)
    ref_ptrs = {k: v.data_ptr() for k, v in
                _flat_tensors(trainer.ref_params).items()}
    history = trainer.train(PROMPTS, np.asarray(jax.random.PRNGKey(2)))
    return {"history": history, "rollouts": rollouts, "engine": engine,
            "trainer": trainer, "ref_ptrs": ref_ptrs}


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_tensors(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


# ------------------------------------------------------------ the pieces


def test_rl_config_from_dict_equals_jax():
    raw = {"roles": {"actor": {"train": True, "learning_rate": 3e-6,
                               "strategy": {"data": 2, "fsdp": 4},
                               "checkpoint_dir": "/ckpt/a"},
                     "ref_model": {"train": False}},
           "ppo": {"gamma": 0.99, "lam": 0.9, "kl_coef": 0.05,
                   "ppo_epochs": 3, "rollout_batch": 16},
           "max_prompt_len": 128}
    for r in (raw, {}, RAW):
        j, t = JaxRLConfig.from_dict(r), RLConfig.from_dict(r)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert sorted(t.roles) == sorted(j.roles)
    t = RLConfig.from_dict(raw)
    assert t.role("critic") is None
    assert t.role("actor").strategy == {"data": 2, "fsdp": 4}


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.9, 0.8)])
def test_compute_gae_alone_and_batched_equals_jax(gamma, lam):
    gen = np.random.default_rng(4)
    r = gen.standard_normal((5, 11)).astype(np.float32)
    v = gen.standard_normal((5, 12)).astype(np.float32)
    j_adv, j_ret = jppo.compute_gae(jnp.asarray(r[0]), jnp.asarray(v[0]),
                                    gamma, lam)
    t_adv, t_ret = tppo.compute_gae(r[0], v[0], gamma, lam)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), atol=1e-6)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), atol=1e-6)
    jb = jax.vmap(lambda a, b: jppo.compute_gae(a, b, gamma, lam))(
        jnp.asarray(r), jnp.asarray(v))
    tb = tppo.compute_gae(torch.from_numpy(r), torch.from_numpy(v), gamma,
                          lam)
    for got, want in zip(tb, jb):
        assert got.dtype == torch.float32 and got.shape == (5, 11)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)


def _ppo_inputs(seed=6, b=4, t=9):
    gen = np.random.default_rng(seed)
    f = lambda *s: gen.standard_normal(s).astype(np.float32)  # noqa: E731
    old = f(b, t)
    mask = (gen.random((b, t)) > 0.3).astype(np.float32)
    return {"logprobs": old + 0.4 * f(b, t), "old_logprobs": old,
            "ref_logprobs": old + 0.1 * f(b, t), "values": f(b, t),
            "old_values": f(b, t), "advantages": f(b, t),
            "returns": f(b, t), "mask": mask}


def test_ppo_loss_five_outputs_equal_jax():
    x = _ppo_inputs()
    ratio = np.exp(x["logprobs"] - x["old_logprobs"])
    clipped = (np.abs(ratio - 1) > 0.2) & (x["mask"] > 0)
    assert 0 < clipped.sum() < (x["mask"] > 0).sum()  # some, not all
    kw = dict(clip_ratio=0.2, value_clip=0.2, vf_coef=0.5, kl_coef=0.1)
    j = jppo.ppo_loss(**{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    t = tppo.ppo_loss(**{k: torch.from_numpy(v) for k, v in x.items()},
                      **kw)
    assert t._fields == j._fields
    for name in t._fields:
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert 0 < float(t.clip_frac) < 1


def test_replay_buffer_rows_and_order_equal_jax():
    jb, tb = jppo.ReplayBuffer(capacity=10, seed=3), tppo.ReplayBuffer(
        capacity=10, seed=3)
    for i in range(13):  # past capacity: the oldest rows go
        row = {"a": np.full((3,), i, np.float32), "i": np.int32(i)}
        jb.add(row)
        tb.add(row)
    assert len(tb) == len(jb) == 10
    got = list(tb.sample_batches(3, epochs=2))
    want = list(jb.sample_batches(3, epochs=2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    tb.clear()
    assert len(tb) == 0


def _loss_batch(seed=8, b=3, s=7):
    gen = np.random.default_rng(seed)
    f = lambda *sh: gen.standard_normal(sh).astype(np.float32)  # noqa: E731
    tokens = gen.integers(0, 31, (b, s)).astype(np.int32)
    mask = np.zeros((b, s - 1), np.float32)
    mask[:, 2:] = 1.0
    old = f(b, s - 1) - 3.0
    return f(b, s, 31), f(b, s), {
        "tokens": tokens, "mask": mask, "old_logp": old,
        "ref_logp": old + 0.2 * f(b, s - 1), "advantages": f(b, s - 1),
        "old_values": f(b, s - 1), "returns": f(b, s - 1)}


def test_token_logprobs_and_losses_and_grads_equal_jax():
    logits, values, batch = _loss_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    w = np.random.default_rng(9).standard_normal(
        batch["mask"].shape).astype(np.float32)

    def jlp(lg):
        return jnp.sum(jtrainer.token_logprobs(lg, jbatch["tokens"]) * w)

    cases = [
        (jlp, lambda lg: torch.sum(ttrainer.token_logprobs(
            lg, tbatch["tokens"]) * torch.from_numpy(w)), logits),
        (lambda lg: jtrainer.actor_ppo_loss(lg, jbatch),
         lambda lg: ttrainer.actor_ppo_loss(lg, tbatch), logits),
        (lambda v: jtrainer.critic_value_loss(v, jbatch),
         lambda v: ttrainer.critic_value_loss(v, tbatch), values),
    ]
    jl_vals = jtrainer.token_logprobs(jnp.asarray(logits), jbatch["tokens"])
    tl_vals = ttrainer.token_logprobs(torch.from_numpy(logits),
                                      tbatch["tokens"])
    np.testing.assert_allclose(tl_vals.numpy(), np.asarray(jl_vals),
                               atol=1e-6)
    for jfn, tfn, x in cases:
        jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        tv = tfn(tx)
        (tg,) = torch.autograd.grad(tv, tx)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)


# ----------------------------------------------------- the whole slice


def test_rollouts_have_jax_tokens(jax_run, port_run):
    assert len(port_run["rollouts"]) == len(jax_run["rollouts"]) == ROUNDS
    for got, want in zip(port_run["rollouts"], jax_run["rollouts"]):
        assert got.shape == (BATCH, PROMPT_LEN + MAX_NEW)
        np.testing.assert_array_equal(got, want)


def test_history_agrees_with_jax(jax_run, port_run):
    """Round 1's KL is 0 on both sides (old and ref logprobs from equal
    weights); the losses and round 2's KL are fp32 sums of the same
    terms, so they agree to an absolute 1e-6 (the actor's loss is near
    0: the normalized advantages have mean 0 and the first minibatch's
    ratio is 1)."""
    jh, th = jax_run["history"], port_run["history"]
    assert len(th) == len(jh) == ROUNDS
    assert th[0]["mean_kl"] == 0.0 == jh[0]["mean_kl"]
    for t, j in zip(th, jh):
        assert t["mean_reward"] == j["mean_reward"]
        for k in ("mean_kl", "actor_loss"):
            assert abs(t[k] - j[k]) < 1e-6, (k, t[k], j[k])
        assert abs(t["critic_loss"] - j["critic_loss"]) < 1e-5 * max(
            1.0, abs(j["critic_loss"]))
    assert th[1]["mean_kl"] != 0.0


def test_final_params_agree_with_jax(jax_run, port_run):
    """After 4 Adam steps (lr 1e-4 actor, 1e-3 critic) every element is
    within half an actor step (5e-5) of JAX's, and all but 0.1 % within
    1e-6: Adam's first steps divide g by |g| + eps, so an element whose
    gradient is ~eps in size may move differently by a part of a step."""
    engine = port_run["engine"]
    for role, lr in (("actor", 1e-4), ("critic", 1e-3)):
        got = _flat(engine.states[role]["params"])
        want = _flat(jax_run[role])
        start = _flat(jax_run[f"{role}0"])
        assert sorted(got) == sorted(want)
        n = off = 0
        for k in got:
            d = np.abs(got[k] - want[k])
            assert d.max() <= 0.5 * lr, (role, k, d.max())
            n += d.size
            off += int((d > 1e-6).sum())
            assert not np.array_equal(got[k], start[k]), (role, k)
        assert off <= 1e-3 * n, (role, off, n)


def test_ref_copy_is_frozen_and_apart_from_the_live_params(jax_run,
                                                           port_run):
    trainer, engine = port_run["trainer"], port_run["engine"]
    ref = _flat(trainer.ref_params)
    start = _flat(jax_run["actor0"])
    live = _flat(engine.states["actor"]["params"])
    for k in ref:
        np.testing.assert_array_equal(ref[k], start[k])
        assert not np.array_equal(live[k], start[k]), k
    live_ptrs = {t.data_ptr() for t in _flat_tensors(
        engine.states["actor"]["params"]).values()}
    assert not live_ptrs & set(port_run["ref_ptrs"].values())
    assert all(not t.requires_grad
               for t in _flat_tensors(trainer.ref_params).values())


# ------------------------------------------- trajectories (the flywheel)


@dataclasses.dataclass
class Traj:
    tokens: np.ndarray
    prompt_len: int
    new_tokens: int
    logprobs: np.ndarray


def _trajectories(actor_params, nan_at=None):
    """Trajectories of unequal lengths whose captured logprobs are the
    actor's own (computed with the JAX forward)."""
    gen = np.random.default_rng(12)
    out = []
    for i, (plen, new) in enumerate(((4, 4), (3, 5), (4, 2))):
        toks = gen.integers(0, V, (plen + new,)).astype(np.int32)
        lp = np.asarray(jtrainer.token_logprobs(
            jax_forward(actor_params, jnp.asarray(toks[None])),
            jnp.asarray(toks[None])))[0, plen - 1:plen + new - 1]
        lp = lp.copy()
        if nan_at == i:
            lp[1] = np.nan
        out.append(Traj(toks, plen, new, lp))
    return out


@pytest.mark.parametrize("nan_at", [None, 1])
def test_experience_from_trajectories_equals_jax(monkeypatch, nan_at):
    jengine = jax_engine()
    actor0 = _tree_np(jengine.states["actor"]["params"])
    critic0 = _tree_np(jengine.states["critic"]["params"])
    trajs = _trajectories(jengine.states["actor"]["params"], nan_at)
    jt = jtrainer.RLHFTrainer(jengine.config, jengine, None, jax_forward,
                              jax_critic, reward_fn, PROMPT_LEN)
    jstats = jt.experience_from_trajectories(trajs)
    tengine = torch_engine(actor0, critic0)
    tt = ttrainer.RLHFTrainer(tengine.config, tengine, None, torch_forward,
                              torch_critic, reward_fn, PROMPT_LEN)
    actor_calls = []
    logp = tt._logp_fn

    def counted(params, tokens):
        if params is tengine.states["actor"]["params"]:
            actor_calls.append(tokens.shape)
        return logp(params, tokens)

    monkeypatch.setattr(tt, "_logp_fn", counted)
    tstats = tt.experience_from_trajectories(trajs)
    # one actor forward for the whole batch, and only when one is NaN
    assert actor_calls == ([] if nan_at is None else [(3, 8)])
    assert tstats["samples"] == jstats["samples"] == 3
    assert tstats["mean_reward"] == jstats["mean_reward"]
    assert abs(tstats["mean_kl"] - jstats["mean_kl"]) < 1e-6
    assert len(tt.buffer) == len(jt.buffer) == 3
    for g, w in zip(tt.buffer._items, jt.buffer._items):
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=ATOL,
                                       err_msg=k)
    assert ttrainer.RLHFTrainer.experience_from_trajectories(tt, []) == {
        "mean_reward": 0.0, "mean_kl": 0.0, "samples": 0}


# ------------------------------------------------------------ the engine


def test_second_role_leaves_the_first_roles_mesh_and_step_intact():
    engine = torch_engine(_tree_np(tl.init_params(
        TCFG, device="cpu", dtype=torch.float32)), {
        "emb": np.zeros((V, E), np.float32), "w": np.ones(E, np.float32)})
    actor, critic = engine.roles["actor"], engine.roles["critic"]
    assert actor.fns.mesh_ctx is actor.mesh_ctx
    assert critic.fns.mesh_ctx is not actor.fns.mesh_ctx
    assert actor.strategy.describe() == critic.strategy.describe()
    batch = {"tokens": torch.from_numpy(PROMPTS[0][:2, :]),
             "mask": torch.ones(2, PROMPT_LEN - 1),
             "old_logp": torch.full((2, PROMPT_LEN - 1), -5.0),
             "ref_logp": torch.full((2, PROMPT_LEN - 1), -5.0),
             "advantages": torch.randn(2, PROMPT_LEN - 1,
                                       generator=torch.Generator()
                                       .manual_seed(0)),
             "old_values": torch.zeros(2, PROMPT_LEN - 1),
             "returns": torch.ones(2, PROMPT_LEN - 1)}
    before = engine.states["actor"]["params"]["lm_head"].detach().clone()
    state, m = actor.fns.train_step(engine.states["actor"], batch)
    assert state["step"] == 1 and np.isfinite(float(m["loss"]))
    assert not torch.equal(state["params"]["lm_head"], before)
    state, m = critic.fns.train_step(engine.states["critic"], batch)
    assert state["step"] == 1 and float(m["loss"]) > 0


def test_set_role_params_checks_shapes_and_keys():
    engine = torch_engine(_tree_np(tl.init_params(
        TCFG, device="cpu", dtype=torch.float32)), {
        "emb": np.zeros((V, E), np.float32), "w": np.ones(E, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        engine.set_role_params("critic", {"emb": np.zeros((V, E + 1)),
                                          "w": np.ones(E)})
    with pytest.raises(ValueError, match="keys"):
        engine.set_role_params("critic", {"emb": np.zeros((V, E))})
    state = engine.set_role_params(
        "critic", {"emb": np.full((V, E), 2.0, np.float32),
                   "w": np.ones(E, np.float32)})
    assert float(state["params"]["emb"][0, 0].detach()) == 2.0
    assert state["params"]["emb"].dtype == torch.float32


def test_example_runs_on_the_cpu_and_cross_process_raises(capsys):
    from dlrover_tpu_torch.examples import rlhf_ppo

    rlhf_ppo.main(["--device", "cpu", "--rounds", "1", "--batch", "4"])
    out = capsys.readouterr().out
    assert "round 0: reward" in out
    with pytest.raises(NotImplementedError, match="A5.1"):
        rlhf_ppo.main(["--device", "cpu", "--cross_process"])
