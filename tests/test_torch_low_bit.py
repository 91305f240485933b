"""The port's int8 moments against the JAX package, on the CPU.

Numpy inputs from a seed go through ``dlrover_tpu.ops.quantization`` /
``dlrover_tpu.optimizers.low_bit`` (Pallas in interpret mode) and their
ports (CPU tensors: every wrapper takes its plain version):

- ``quantize_blockwise`` / ``dequantize_blockwise``: payload, scales,
  payload shape and meta equal bit for bit, over ragged sizes, zeros,
  the half-way block (absmax 127, values at .5) and ``n == 0``;
- ``fused_int8_adam_update`` at steps 1 and 3;
- ``QuantizedMoments`` against ``quantized_moments`` +
  ``optax.apply_updates`` over 5 steps from a non-zero state carried
  across by ``quantized_state_from_jax``;
- a tiny Llama trained 3 steps through ``auto_accelerate``;
- the state sized on ``meta``, and no CPU fallback for a tensor that is
  not on the CPU.

Tolerances.  Quantize and dequantize are exact.  The fused update may
differ from the JAX one in the last bits because XLA's CPU code
contracts ``b1 * mu + (1 - b1) * g`` into one FMA (``fma(1 - b1, g, b1 *
mu)``, found by matching its new mu scales), which the port does not
(its kernel must match its plain version bit for bit on the card): so an
int8 payload may land one count apart on at most 1 in 10^4 elements,
scales agree to ``rtol=1e-6`` and the update to ``rtol=1e-5, atol=1e-8``
(the JAX package's own limits, ``tests/test_optimizers.py``).  Params
after 5 optimizer steps or 3 train steps: ``2e-5`` (the AGD limit of
``tests/test_torch_train.py``; a payload one count apart moves an
update by a fraction of ``lr``, so the train steps run at the chip
leg's ``lr = 3e-4``); losses ``1e-5``.
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
from dlrover_tpu_torch.accelerate import auto_accelerate  # noqa: E402
from dlrover_tpu_torch.accelerate.api import analyse_model  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.ops import _build  # noqa: E402
from dlrover_tpu_torch.ops import quantization as tq  # noqa: E402
from dlrover_tpu_torch.optimizers import (  # noqa: E402
    QuantizedMoments,
    dequantize_qtensor,
    quantized_state_from_jax,
)
from dlrover_tpu_torch.parallel.train_step import param_leaves  # noqa: E402

jq = importlib.import_module("dlrover_tpu.ops.quantization")
jlow = importlib.import_module("dlrover_tpu.optimizers.low_bit")

LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def _halfway():
    """One block whose absmax is 127 (scale exactly 1.0) holding values
    at half-counts: round half to even gives 0, 2, 126, -2, ..."""
    x = np.zeros(1024, np.float32)
    x[:8] = [127.0, 0.5, 2.5, 126.5, -0.5, -2.5, -126.5, 1.5]
    return x


def _case(name):
    rng = np.random.default_rng(0)
    if name == "zeros":
        return np.zeros(2048, np.float32)
    if name == "halfway":
        return _halfway()
    if name == "empty":
        return np.zeros((0, 3), np.float32)
    return (3.0 * rng.standard_normal(name)).astype(np.float32)


@pytest.mark.parametrize("name", [
    (1024,), (300,), (17, 257), (9000,), (16 * 1024 + 5,), "zeros",
    "halfway", "empty",
])
def test_quantize_and_dequantize_match_jax_bit_for_bit(name):
    x = _case(name)
    jqv, js, jmeta = jq.quantize_blockwise(jnp.asarray(x))
    q, s, meta = tq.quantize_blockwise(torch.from_numpy(x))
    assert meta == jmeta
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == jqv.shape and tuple(s.shape) == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tq.dequantize_blockwise(q, s, meta)
    jback = jq.dequantize_blockwise(jqv, js, jmeta)
    assert back.shape == x.shape and back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    if name == "halfway":
        assert float(s[0, 0]) == 1.0
        assert q.view(-1)[:8].tolist() == [127, 0, 2, 126, 0, -2, -126, 2]


def test_layout_and_bias_corrections():
    # _pad_to_blocks: whole blocks, > 8 rounded up to a multiple of 8
    assert [tq.padded_blocks(n) for n in (1, 1024, 8 * 1024, 8 * 1024 + 1,
                                          9 * 1024 + 17, 131072)] == [
        1, 1, 8, 16, 16, 128]
    assert tq.RECIP_127 == float(np.float32(1 / 127))
    for step in (1, 3, 1000):
        stepf = jnp.asarray(step, jnp.float32)
        want = (float(1.0 - B1 ** stepf), float(1.0 - B2 ** stepf))
        assert tq.bias_corrections(B1, B2, step) == want


def _close_int8(got, want):
    """Payloads equal, or one count apart on at most 1 in 10^4."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4


def _moments(rng, shape):
    mu0 = (0.1 * rng.normal(size=shape)).astype(np.float32)
    nu0 = (0.01 * np.abs(rng.normal(size=shape))).astype(np.float32)
    return jq.quantize_blockwise(jnp.asarray(mu0)), jq.quantize_blockwise(
        jnp.asarray(np.sqrt(nu0)))


@pytest.mark.parametrize("shape", [(64,), (300,), (48, 130), (9000,)])
@pytest.mark.parametrize("step", [1, 3])
def test_fused_update_matches_jax(shape, step):
    rng = np.random.default_rng(step)
    g = rng.normal(size=shape).astype(np.float32)
    (mq, ms, meta), (nq, ns, _) = _moments(rng, shape)
    bc1, bc2 = tq.bias_corrections(B1, B2, step)
    want = jq.fused_int8_adam_update(
        jnp.asarray(g), mq, ms, nq, ns, meta, jnp.float32(bc1),
        jnp.float32(bc2), lr=LR, b1=B1, b2=B2, eps=EPS)
    got = tq.fused_int8_adam_update(
        torch.from_numpy(g), *map(_t, (mq, ms, nq, ns)), meta, bc1, bc2,
        lr=LR, b1=B1, b2=B2, eps=EPS)
    assert got[0].shape == shape and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-8)
    for i in (1, 3):
        _close_int8(got[i].numpy(), want[i])
        np.testing.assert_allclose(got[i + 1].numpy(), np.asarray(want[i + 1]),
                                   rtol=1e-6)


def test_fused_update_out_and_inplace_equal_the_functional_form():
    rng = np.random.default_rng(4)
    shape = (5, 2000)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    (mq, ms, meta), (nq, ns, _) = _moments(rng, shape)
    state = [_t(a) for a in (mq, ms, nq, ns)]
    kw = dict(lr=LR, b1=B1, b2=B2, eps=EPS)
    ref = tq.fused_int8_adam_update(g, *state, meta, 0.19, 0.002, **kw)
    grad = g.clone()
    got = tq.fused_int8_adam_update(grad, *state, meta, 0.19, 0.002,
                                    out=grad, inplace=True, **kw)
    assert got[0].data_ptr() == grad.data_ptr()
    assert all(a is b for a, b in zip(got[1:], state))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # n == 0 launches nothing and hands the state back
    e = torch.zeros(0)
    q0, s0, meta0 = tq.quantize_blockwise(e)
    out = tq.fused_int8_adam_update(e, q0, s0, q0, s0, meta0, 0.1, 0.1, **kw)
    assert out[0].shape == (0,) and out[1] is q0


# -------------------------------------------------------- optimizer


def _jax_state(params, grads, steps, opt):
    state = opt.init(params)
    for g in grads[:steps]:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_quantized_moments_matches_jax_over_five_steps(wd):
    rng = np.random.default_rng(7)
    shapes = {"a": (40, 130), "b": {"c": (9000,), "d": (7,)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(7)]
    opt = jlow.quantized_moments(LR, weight_decay=wd)
    update = jax.jit(opt.update)
    # two steps first, so both sides start from a non-zero int8 state
    jp, state = _jax_state(jax.tree_util.tree_map(jnp.asarray, params),
                           grads, 2, opt)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu", dtype=torch.float32)
    leaves = param_leaves(tp)
    topt = QuantizedMoments(leaves, lr=LR, weight_decay=wd)
    quantized_state_from_jax(jax.tree_util.tree_map(np.asarray, state), tp,
                             topt)
    assert topt.param_groups[0]["step"] == 2
    for p, mu in zip(leaves, jax.tree_util.tree_leaves(
            state.mu, is_leaf=lambda x: isinstance(x, jlow._QTensor))):
        assert np.abs(mu.q).max() > 0
        np.testing.assert_array_equal(topt.state[p]["mu_q"].numpy(), mu.q)
    for g in grads[2:]:
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gl in zip(leaves, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(np.array(gl))
        topt.step()
    assert topt.param_groups[0]["step"] == int(state.step) == 7
    is_q = lambda x: isinstance(x, jlow._QTensor)  # noqa: E731
    for p, want, mu, nu in zip(
            leaves, jax.tree_util.tree_leaves(jp),
            jax.tree_util.tree_leaves(state.mu, is_leaf=is_q),
            jax.tree_util.tree_leaves(state.nu, is_leaf=is_q)):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)
        st = topt.state[p]
        _close_int8(st["mu_q"].numpy(), mu.q)
        _close_int8(st["nu_q"].numpy(), nu.q)
        np.testing.assert_allclose(st["mu_scales"].numpy(), mu.scales,
                                   rtol=1e-6)
        np.testing.assert_allclose(st["nu_scales"].numpy(), nu.scales,
                                   rtol=1e-6)
        t_mu, t_nu = topt.moments(p)
        np.testing.assert_array_equal(
            dequantize_qtensor(t_mu).numpy(),
            np.asarray(jlow.dequantize_qtensor(
                jlow._QTensor(jnp.asarray(st["mu_q"].numpy()),
                              jnp.asarray(st["mu_scales"].numpy()),
                              mu.shape, mu.n))))
        assert t_nu.shape == tuple(p.shape)


def test_tiny_llama_train_step_matches_jax():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat="none")
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="none")
    jp = jl.init_params(jax.random.PRNGKey(3), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 11)).astype(np.int32)
               for _ in range(3)]
    # the leg's lr: here the grads differ in their last bits (XLA's sums
    # against PyTorch's), which can move a payload by one count, and that
    # moves a param by up to ~lr / 50 from step 2 on
    lr = 3e-4
    opt = jlow.quantized_moments(lr, weight_decay=0.1)
    state = opt.init(jp)

    @jax.jit
    def jstep(p, st, toks):
        loss, g = jax.value_and_grad(lambda q: jl.loss_fn(
            q, {"tokens": toks}, jcfg, jl.dot_product_attention))(p)
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st, loss

    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, tcfg),
        optimizer=lambda ps: QuantizedMoments(ps, lr=lr, weight_decay=0.1),
        init_params_fn=lambda gen, dev: jax.tree_util.tree_map(
            lambda t: t.to(dev), params_from_jax(npp, "cpu", torch.float32)),
        device="cpu",
    )
    st = result.fns.init_state(0)
    for toks in batches:
        jp, state, jloss = jstep(jp, state, jnp.asarray(toks))
        st, m = result.fns.train_step(st, {"tokens": torch.from_numpy(toks)})
        assert abs(float(m["loss"]) - float(jloss)) <= 1e-5
    assert st["opt_state"].param_groups[0]["step"] == 3
    for got, want in zip(param_leaves(st["params"]),
                         jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)


def test_analyse_model_sizes_the_int8_state_on_meta():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    before = dict(_build.launches)
    prof = analyse_model(
        lambda gen, dev: tl.init_params(cfg, gen, dev, dtype=torch.float32),
        lambda ps: QuantizedMoments(ps))
    assert _build.launches == before
    leaves = param_leaves(tl.init_params(cfg, None, "meta"))
    want = sum(2 * (tq.padded_blocks(p.numel()) * (tq.BLOCK + 4))
               for p in leaves)
    assert prof.optimizer_bytes == want
    # about 2 bytes per parameter: payload plus scales and block padding
    assert 2 * prof.num_params <= want <= 2.5 * prof.num_params


def test_a_tensor_off_the_cpu_takes_the_kernel_or_raises(monkeypatch,
                                                         tmp_path):
    p = torch.ones(3000, requires_grad=True)
    opt = QuantizedMoments([p])
    opt.init_state()
    p.grad = torch.ones(3000)
    # as a CUDA tensor would: the wrapper goes to the kernel, whose build
    # fails here (no nvcc), and nothing falls back to the plain version
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    before = p.detach().clone()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        opt.step()
    assert torch.equal(p.detach(), before)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tq.quantize_blockwise(torch.ones(5))
    monkeypatch.undo()
    # a device that is neither the CPU nor CUDA raises
    q, s, meta = tq.quantize_blockwise(torch.ones(5))
    with pytest.raises(ValueError, match="unsupported device"):
        tq.fused_int8_adam_update(
            torch.ones(5, device="meta"), q, s, q, s, meta, 0.1, 0.1,
            lr=LR, b1=B1, b2=B2, eps=EPS)
