"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through
``dlrover_tpu.ops.flash_attention`` (its Pallas kernels in interpret
mode, as ``tests/test_ops.py`` runs them here, with 32-row blocks so
that ``S = 100`` leaves a ragged tail block and ``S = 64`` does not) and
through ``dlrover_tpu_torch.ops.flash_attention`` (CPU tensors: the
plain versions of the B2-B4 kernels, which ``chip_smoke.py`` holds the
CUDA kernels against on the card).  Compared: ``O``, ``lse`` itself
(the natural-log, scaled-score convention the backward relies on), and
``dq, dk, dv`` with the lse cotangent zero and nonzero.

Tolerance: fp32 atol 2e-5 on unit-scale inputs (online against
two-pass softmax, sums in another order).
"""

import importlib
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models.llama import dot_product_attention  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.ops import _build  # noqa: E402
from dlrover_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# the package re-exports a function of the module's name
jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")

ATOL = 2e-5
BLOCK = 32


def _inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    go = rng.standard_normal((b, s, h, d)).astype(np.float32)
    glse = rng.standard_normal((b, s, h)).astype(np.float32)
    return q, k, v, go, glse


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 100])
@pytest.mark.parametrize("h,kv", [(4, 2), (2, 2)])
def test_flash_attention_lse_and_grads_match_jax(causal, s, h, kv):
    q, k, v, go, glse = _inputs(s + h + int(causal), 2, s, h, kv, 16)

    def jax_loss(q, k, v):
        o, lse = jfa.flash_attention_lse(
            q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(o * go) + jnp.sum(lse * glse), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = tfa.flash_attention_lse(tq, tk, tv, causal=causal)
    assert o.shape == (2, s, h, 16) and lse.shape == (2, s, h)
    assert lse.dtype == torch.float32
    ((o * torch.from_numpy(go)).sum()
     + (lse * torch.from_numpy(glse)).sum()).backward()
    for got, want in zip((o, lse, tq.grad, tk.grad, tv.grad),
                         (jo, jlse) + tuple(jg)):
        _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 100])
def test_flash_attention_grads_match_jax_without_lse(causal, s):
    """The plain output path: no lse cotangent (glse zero)."""
    q, k, v, go, _ = _inputs(7 * s + int(causal), 1, s, 4, 1, 32)

    def jax_loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                block_k=BLOCK)
        return jnp.sum(o * go), o

    (_, jo), jg = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    (o * torch.from_numpy(go)).sum().backward()
    for got, want in zip((o, tq.grad, tk.grad, tv.grad), (jo,) + tuple(jg)):
        _close(got, want)


@pytest.mark.parametrize("d", [16, 32])
def test_small_head_dims_match_jax(d):
    """head_dim 16 (``LlamaConfig.tiny()``) and 32, which the kernels
    take since the FMA path covers them in bf16 too: O, lse and the
    three grads against the Pallas kernels in interpret mode, GQA group
    2, causal, a ragged tail block."""
    q, k, v, go, glse = _inputs(40 + d, 1, 100, 4, 2, d)

    def jax_loss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, causal=True,
                                         block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(o * go) + jnp.sum(lse * glse), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = tfa.flash_attention_lse(tq, tk, tv, causal=True)
    ((o * torch.from_numpy(go)).sum()
     + (lse * torch.from_numpy(glse)).sum()).backward()
    assert d in tfa.HEAD_DIMS and o.shape[-1] == d
    for got, want in zip((o, lse, tq.grad, tk.grad, tv.grad),
                         (jo, jlse) + tuple(jg)):
        _close(got, want)


def test_flash_matches_dense_reference_of_both_packages():
    """``flash_attention`` equals the JAX package's
    ``dot_product_attention`` and the port's, with S = 1 included."""
    for s in (1, 37):
        q, k, v, _, _ = _inputs(s, 2, s, 4, 2, 16)
        want = dot_product_attention(q, k, v, causal=True)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        _close(tfa.flash_attention(tq, tk, tv), want)
        _close(tl.dot_product_attention(tq, tk, tv), want)


def test_plain_kernel_pieces_match_autograd_of_the_plain_forward():
    """The three plain kernel versions are the gradient of the plain
    forward (torch autograd through dense attention, fp32)."""
    q, k, v, go, glse = _inputs(3, 1, 45, 4, 2, 16)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    scale = 16 ** -0.5
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, True, scale)
    (torch.sum(o * torch.from_numpy(go))
     + torch.sum(lse.transpose(1, 2) * torch.from_numpy(glse))).backward()
    dout = torch.from_numpy(go)
    args = (tq.detach(), tk.detach(), tv.detach(), dout, lse.detach(),
            tfa.attention_delta(o.detach(), dout),
            torch.from_numpy(glse).transpose(1, 2).contiguous(), True, scale)
    dk, dv = tfa.flash_bwd_dkv_plain(*args)
    dq = tfa.flash_bwd_dq_plain(*args)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_bf16_forward_rounds_p_like_the_reference():
    """bf16: O within one bf16 rounding of JAX's (p cast to bf16 before
    p v in both), lse within fp32 noise."""
    q, k, v, _, _ = _inputs(11, 1, 64, 2, 2, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jlse = jfa.flash_attention_lse(jq, jk, jv, block_q=BLOCK,
                                       block_k=BLOCK)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = tfa.flash_attention_lse(tq, tk, tv)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-4)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    _build.reset_launches()
    q, k, v, _, _ = _inputs(5, 1, 8, 2, 1, 16)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv).sum().backward()
    assert all(_build.launches[n] == 0
               for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 8)
    k = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="head_dim 16, 32, 64 or 128"):
        tfa.flash_fwd_kernel(q, k, k, True, 0.25)
    q64 = torch.zeros(1, 8, 3, 64)
    k64 = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="does not fit"):
        tfa.flash_fwd_kernel(q64, k64, k64, True, 0.125)
    with pytest.raises(TypeError, match="fp32/bf16"):
        tfa.flash_fwd_kernel(q64.half(), k64.half(), k64.half(), True, 0.1)
    with pytest.raises(ValueError, match="not a multiple"):
        tfa.flash_attention(q64, k64, k64)
    with pytest.raises(ValueError, match="device mix"):
        tfa.flash_fwd(q64.to("meta"), k64, k64, True, 0.1)
