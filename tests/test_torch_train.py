"""The port's training path against the JAX package, on the CPU.

Numpy inputs from a seed go through the JAX functions and their ports
(CPU tensors: every kernel wrapper takes its plain version):

- ``rms_norm`` forward and backward against the JAX ``custom_vjp``,
  bf16 ``x`` with an fp32 weight (the training mix) and fp32; the same
  for ``add_rms_norm`` against ``x + d`` and the norm of it;
- ``fused_linear_cross_entropy`` loss and grads, with a ragged last
  chunk and a mask;
- ``loss_fn`` value and grads, dense and fused CE, ``remat`` none and
  full (which must agree exactly with each other);
- ``AGD`` against ``dlrover_tpu.optimizers.agd`` over 5 steps;
- ``train_step`` (through ``auto_accelerate``) over 3 steps with 1 and 2
  micro steps, against ``jax.value_and_grad(loss_fn)`` + ``agd().update``;
- ``Trainer.train`` + ``evaluate``, and the options left out, which
  raise ``NotImplementedError``.

Tolerances (fp32 unless stated): 1e-5 absolute on unit-scale values
(sums in another order); RMSNorm bf16 outputs within one bf16 ulp
(2^-7 at |y| < 2); parameters after AGD steps 2e-5 (AGD's step is
``lr * m / max(sqrt(v), delta)``, sign-like, so a gradient that differs
in its last bits moves the step by up to ``lr`` times its relative
difference over ``delta``).
"""

import importlib
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu_torch.accelerate import (  # noqa: E402
    Strategy,
    auto_accelerate,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.ops import fused as tfused  # noqa: E402
from dlrover_tpu_torch.optimizers import AGD  # noqa: E402
from dlrover_tpu_torch.parallel import build_train_step  # noqa: E402
from dlrover_tpu_torch.parallel.train_step import param_leaves  # noqa: E402
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs  # noqa: E402

# the packages re-export functions of their modules' names
jfused = importlib.import_module("dlrover_tpu.ops.fused")
jagd = importlib.import_module("dlrover_tpu.optimizers.agd")

ATOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _flat(tree):
    return jax.tree_util.tree_leaves(tree)


# --------------------------------------------------------------- rms


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_rms_norm_forward_and_backward_match_jax(x_dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 1e-3 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x, jdt)
    jy, vjp = jax.vjp(lambda a, b: jfused.rms_norm(a, b, 1e-5), jx,
                      jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = tfused.rms_norm(tx, tw, 1e-5)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt
    assert tw.grad.dtype == torch.float32
    ulp = 2 ** -7 if x_dtype == "bfloat16" else ATOL
    _close(y, jy, ulp)
    _close(tx.grad, jdx, ulp)
    # dw sums 15 rows of g * xhat in fp32 from the same bf16 inputs
    _close(tw.grad, jdw, 1e-4)


def _within_ulp(got, want, x_dtype):
    """bf16: each element within one bf16 ulp of the reference's value;
    fp32: ``ATOL``."""
    g, r = _np(got), _np(want)
    if x_dtype == "float32":
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
        return
    e = np.floor(np.log2(np.maximum(np.abs(r), 1e-30)))
    assert np.all(np.abs(g - r) <= 2.0 ** (e - 7))


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_add_rms_norm_forward_and_backward_match_jax(x_dtype):
    """``add_rms_norm`` against ``jax.vjp`` of ``(x + d, rms_norm(x + d,
    w))`` with a cotangent for each output: ``h`` bit for bit; ``y`` and
    the gradients of ``x`` and ``d`` (equal: both are h's) within one
    bf16 ulp (fp32: 1e-5); ``dw`` 1e-4 (15 rows summed in fp32)."""
    rng = np.random.default_rng(5)
    x, d, g_h, g_y = (rng.standard_normal((3, 5, 64)).astype(np.float32)
                      for _ in range(4))
    w = (1 + 1e-3 * rng.standard_normal(64)).astype(np.float32)
    jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32

    def ref(a, b, c):
        s = a + b
        return s, jfused.rms_norm(s, c, 1e-5)

    (jh, jy), vjp = jax.vjp(ref, jnp.asarray(x, jdt), jnp.asarray(d, jdt),
                            jnp.asarray(w))
    jdx, jdd, jdw = vjp((jnp.asarray(g_h, jdt), jnp.asarray(g_y, jdt)))
    tx, td = (torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (x, d))
    tw = torch.from_numpy(w).requires_grad_(True)
    h, y = tfused.add_rms_norm(tx, td, tw, 1e-5)
    torch.autograd.backward(
        [h, y], [torch.from_numpy(g_h).to(tdt), torch.from_numpy(g_y).to(tdt)])
    assert h.dtype == y.dtype == tx.grad.dtype == td.grad.dtype == tdt
    assert tw.grad.dtype == torch.float32
    np.testing.assert_array_equal(_np(h), _np(jh))
    _within_ulp(y, jy, x_dtype)
    _within_ulp(tx.grad, jdx, x_dtype)
    assert torch.equal(tx.grad, td.grad)
    np.testing.assert_array_equal(_np(jdx), _np(jdd))
    _close(tw.grad, jdw, 1e-4)


def test_add_rms_norm_without_grad_is_the_bare_forward():
    x, d = torch.randn(4, 64), torch.randn(4, 64)
    w = torch.ones(64)
    h, y = tfused.add_rms_norm(x, d, w)
    assert h.grad_fn is None and y.grad_fn is None
    assert torch.equal(h, x + d)
    assert torch.equal(y, tfused.rms_norm_plain(x + d, w)[0])


def test_rms_norm_without_grad_is_the_bare_forward():
    x = torch.randn(4, 64)
    w = torch.ones(64)
    y = tfused.rms_norm(x, w)
    assert y.grad_fn is None
    torch.testing.assert_close(y, tfused.rms_norm_plain(x, w)[0])


# ------------------------------------------------------- fused CE


@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_linear_ce_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 23, 32)).astype(np.float32)
    w = (0.2 * rng.standard_normal((32, 97))).astype(np.float32)
    t = rng.integers(0, 97, (2, 23)).astype(np.int32)
    m = (rng.random((2, 23)) > 0.3).astype(np.float32) if with_mask else None

    def jloss(h, w):
        return jfused.fused_linear_cross_entropy(
            h, w, t, None if m is None else jnp.asarray(m), chunk_rows=8)

    jv, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(h, w)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = tfused.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(t),
        None if m is None else torch.from_numpy(m), chunk_rows=8)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    _close(loss, jv)
    _close(th.grad, jdh)
    _close(tw.grad, jdw)


def test_fused_ce_equals_dense_ce():
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((37, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 50)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 50, 37))
    dense = torch.nn.functional.cross_entropy(h @ w, t)
    for chunk in (1, 5, 37, 512):
        fused = tfused.fused_linear_cross_entropy(h, w, t, chunk_rows=chunk)
        torch.testing.assert_close(fused, dense, atol=ATOL, rtol=0)


# ------------------------------------------------------------- model


def _pair(**over):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat="none", **over)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="none", **over)
    jp = jl.init_params(jax.random.PRNGKey(3), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, npp


def _torch_params(npp, device="cpu"):
    tp = params_from_jax(npp, device="cpu", dtype=torch.float32)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.clone().to(device)

    return walk(tp)


def _batch(rng, b, s, vocab, mask=False):
    batch = {"tokens": rng.integers(0, vocab, (b, s + 1)).astype(np.int32)}
    if mask:
        batch["mask"] = (rng.random((b, s)) > 0.25).astype(np.float32)
    return batch


@pytest.mark.parametrize("fused_ce", [False, True])
def test_loss_fn_value_and_grads_match_jax(fused_ce):
    jcfg, tcfg, jp, npp = _pair()
    batch = _batch(np.random.default_rng(4), 2, 12, jcfg.vocab_size, True)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, jl.dot_product_attention, fused_ce)))(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    results = []
    for remat in ("none", "full"):
        cfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat=remat)
        tp = _torch_params(npp)
        leaves = param_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = tl.loss_fn(tp, tbatch, cfg, fused_ce=fused_ce)
        grads = torch.autograd.grad(loss, leaves)
        _close(loss, jv)
        for got, want in zip(grads, _flat(jg)):
            _close(got, want)
        results.append((loss, grads))
    # remat recomputes the same forward: bit-identical
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_loss_fn_inputs_targets_form_and_logits_match_jax():
    jcfg, tcfg, jp, npp = _pair(n_kv_heads=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    tp = _torch_params(npp)
    _close(tl.forward(tp, torch.from_numpy(toks), tcfg),
           jl.forward(jp, jnp.asarray(toks), jcfg, jl.dot_product_attention),
           1e-4)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    jv = jl.loss_fn(jp, {"inputs": jnp.asarray(inputs),
                         "targets": jnp.asarray(targets)}, jcfg,
                    jl.dot_product_attention)
    tv = tl.loss_fn(tp, {"inputs": torch.from_numpy(inputs),
                         "targets": torch.from_numpy(targets)}, tcfg)
    tv_tokens = tl.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(tv, jv)
    assert torch.equal(tv, tv_tokens)
    # the dense reference attention gives the same loss as flash
    _close(tl.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                      attention_fn=tl.dot_product_attention), jv)


def test_bf16_compute_with_fp32_masters_gives_fp32_grads():
    cfg = tl.LlamaConfig.tiny(remat="full")  # bf16 compute
    tp = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.float32)
    leaves = param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(_batch(rng, 2, 8, 256)["tokens"])}
    loss = tl.loss_fn(tp, batch, cfg)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    h = tl.forward_hidden(tp, batch["tokens"][:, :-1], cfg)
    assert h.dtype == torch.bfloat16
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_params_from_jax_gives_fp32_masters():
    _, _, _, npp = _pair()
    tp = params_from_jax(npp, device="cpu", dtype=torch.float32)
    leaves = param_leaves(tp)
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    for got, want in zip(leaves, _flat(npp)):
        assert np.array_equal(got.numpy(), want)


# --------------------------------------------------------------- AGD


@pytest.mark.parametrize("wd,amsgrad,clip", [
    (0.0, False, None), (0.1, False, None), (0.0, True, None),
    (0.05, True, 0.5),
])
def test_agd_matches_jax_over_five_steps(wd, amsgrad, clip):
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    opt = jagd.agd(1e-2, weight_decay=wd, amsgrad=amsgrad, clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    topt = AGD(list(tp.values()), lr=1e-2, weight_decay=wd,
               amsgrad=amsgrad, clip=clip)
    for g in grads:
        updates, state = opt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        _close(tp[k], jp[k], 2e-6)
        _close(topt.state[tp[k]]["exp_avg"], state.exp_avg[k], 2e-6)
        _close(topt.state[tp[k]]["exp_avg_sq"], state.exp_avg_sq[k], 2e-6)
    assert topt.state[tp["a"]]["step"] == 5


# --------------------------------------------------- train step, trainer


def _init_fn(npp):
    return lambda gen, dev: _torch_params(npp, dev)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax_over_three_steps(micro):
    jcfg, tcfg, jp, npp = _pair()
    rng = np.random.default_rng(8)
    batches = [_batch(rng, 4, 10, jcfg.vocab_size) for _ in range(3)]
    opt = jagd.agd(1e-3)
    state = opt.init(jp)

    def jloss(p, b):
        return jl.loss_fn(p, b, jcfg, jl.dot_product_attention)

    jgrad = jax.jit(jax.value_and_grad(jloss))
    jupdate = jax.jit(opt.update)
    jax_metrics = []
    for batch in batches:
        toks = batch["tokens"]
        mb = toks.shape[0] // micro
        loss_sum, grad_sum = 0.0, None
        for i in range(micro):
            loss, grads = jgrad(
                jp, {"tokens": jnp.asarray(toks[i * mb:(i + 1) * mb])})
            loss_sum = loss_sum + loss
            grad_sum = grads if grad_sum is None else jax.tree_util.tree_map(
                jnp.add, grad_sum, grads)
        grads = jax.tree_util.tree_map(lambda g: g / micro, grad_sum)
        updates, state = jupdate(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        jax_metrics.append((loss_sum / micro, optax.global_norm(grads)))

    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, tcfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=_init_fn(npp),
        load_strategy=Strategy(num_micro_steps=micro),
        device="cpu",
    )
    assert result.strategy.describe() == "single-device"
    assert result.profile.num_params == sum(x.size for x in _flat(npp))
    # fp32 params, exp_avg and exp_avg_sq
    assert result.profile.optimizer_bytes == 2 * result.profile.param_bytes
    st = result.fns.init_state(0)
    for batch, (jloss_v, jnorm) in zip(batches, jax_metrics):
        st, metrics = result.fns.train_step(
            st, {"tokens": torch.from_numpy(batch["tokens"])})
        _close(metrics["loss"], jloss_v)
        _close(metrics["grad_norm"], jnorm, 1e-4)
    assert st["step"] == 3
    for got, want in zip(param_leaves(st["params"]), _flat(jp)):
        _close(got, want, 2e-5)


def _tiny_result(npp, tcfg, micro=1):
    return auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, tcfg),
        optimizer=lambda ps: AGD(ps, lr=3e-3),
        init_params_fn=_init_fn(npp),
        load_strategy=Strategy(num_micro_steps=micro),
        device="cpu",
    )


def test_trainer_train_and_evaluate_on_cpu():
    _, tcfg, _, npp = _pair()
    result = _tiny_result(npp, tcfg)
    fixed = _batch(np.random.default_rng(9), 2, 12, tcfg.vocab_size)

    def data_iter():
        for _ in range(3):  # exhausts: the trainer starts a new epoch
            yield fixed

    def eval_iter():
        yield fixed
        yield fixed

    trainer = Trainer(result, TrainingArgs(max_steps=8, eval_interval=4,
                                           log_interval=2),
                      data_iter, eval_iter_fn=eval_iter)
    before = trainer.evaluate()
    summary = trainer.train()
    after = trainer.evaluate(max_batches=1)
    assert summary["final_step"] == 8 and summary["mean_step_time"] > 0
    assert [r["step"] for r in trainer.history] == list(range(1, 9))
    losses = [r["loss"] for r in trainer.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(r["grad_norm"] > 0 for r in trainer.history)
    assert before["eval_batches"] == 2 and after["eval_batches"] == 1
    assert after["eval_loss"] < before["eval_loss"]
    # the eval loss is the forward loss of the trained params
    ev = tl.loss_fn(trainer.state["params"],
                    {"tokens": torch.from_numpy(fixed["tokens"])}, tcfg)
    assert abs(after["eval_loss"] - float(ev.detach())) < 1e-6


def test_build_train_step_alone_and_its_errors():
    _, tcfg, _, npp = _pair()
    fns = build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg),
                           lambda ps: AGD(ps), _init_fn(npp),
                           num_micro_steps=3, device="cpu")
    st = fns.init_state()
    with pytest.raises(ValueError, match="does not split"):
        fns.train_step(st, {"tokens": torch.zeros(4, 9, dtype=torch.long)})
    with pytest.raises(ValueError, match="num_micro_steps"):
        build_train_step(None, None, None, num_micro_steps=0, device="cpu")


# ------------------------------------------------------ left out, raises


def test_left_out_options_raise_not_implemented():
    _, tcfg, _, npp = _pair()
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="dots")
    tp = _torch_params(npp)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        tl.loss_fn(tp, {"tokens": torch.zeros(1, 5, dtype=torch.long)}, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tl.LlamaConfig.tiny(tie_word_embeddings=True)
    result = _tiny_result(npp, tcfg)
    for name, value, where in (
        ("replay_dir", "/x", "A3b"),
        ("trace_interval", 5, "A7"), ("metrics_port", 9000, "A7"),
        ("sparse_tables", {"t": object()}, "A7"),
    ):
        args = TrainingArgs(max_steps=1, **{name: value})
        with pytest.raises(NotImplementedError, match=f"ROADMAP {where}"):
            Trainer(result, args, lambda: iter(()))
    kw = dict(loss_fn=None, optimizer=None, init_params_fn=_init_fn(npp))
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        auto_accelerate(**kw, devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        auto_accelerate(**kw, load_strategy=Strategy(data=2), device="cpu")


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, npp = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        auto_accelerate(lambda p, b: None, AGD, _init_fn(npp))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_step(lambda p, b: None, AGD, _init_fn(npp))
    from dlrover_tpu_torch.examples import llama_pretrain

    with pytest.raises(RuntimeError, match="CUDA"):
        llama_pretrain.main(["--steps", "1"])
    summary, trainer = llama_pretrain.main(
        ["--device", "cpu", "--steps", "3", "--dim", "32", "--layers", "1",
         "--heads", "2", "--seq", "8", "--batch", "2"])
    assert summary["final_step"] == 3 and len(trainer.history) == 3
