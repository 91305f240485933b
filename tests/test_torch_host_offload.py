"""The port's host-offloaded AdamW against the JAX package, on the CPU.

Numpy inputs from a seed go through ``dlrover_tpu.optimizers.host_offload``
(its ``numpy`` backend; the fused builders on the CPU mesh, where its host
sharding is device memory) and ``dlrover_tpu_torch.optimizers.host_offload``
(``device="cpu"``: host state as plain tensors, every kernel wrapper its
plain version):

- ``apply_gradients`` over 5 steps, fp32 and int8 moments, weight decay
  on, at a chunk that splits every leaf, a chunk that is not a whole
  number of 1,024-element blocks and a leaf smaller than one block;
- the checkpoint round trip, and a JAX state carried across by
  ``offload_state_from_jax`` (numpy and pinned layouts);
- every step mode over ``LlamaConfig.tiny`` with carried params (fp32
  compute, bf16 params, as the offloaded state keeps them): chunked,
  fused, fused_delayed, ``micro_steps=2`` (chunked and fused), grouped
  N = 2 and 3; delayed against the synchronous steps on the grads
  shifted by one step, micro against the mean grads, grouped against one
  group, and ``init_ngrouped_params``' boundary validation;
- the ``offload_copy`` span's labels and both switches
  (``DLROVER_TPU_OFFLOAD_BUFFERED``, ``DLROVER_TPU_OFFLOAD_QUANT``); the
  quantized wire's host quantize and dequantize against
  ``_np_quant_chunk`` / ``_np_deq_chunk`` bit for bit.

Tolerances.
- fp32 moments: masters within ``rtol=2e-5, atol=5e-7`` of JAX's (the
  reference's own limit against optax: XLA's CPU code contracts
  ``b1 * mu + (1 - b1) * g`` into an FMA, the port does not), bf16
  params within one bf16 ulp of |master|.
- int8 moments: the port's chunk update is its B9 kernel's plain
  version, which rounds ``(b2 * r) * r`` where the JAX chunk rounds
  ``b2 * (r * r)``: a payload may land one count apart, on at most 1 %
  of a leaf's elements (the limit the ``[int8]`` checks read as
  "differing elements"), scales within ``rtol=1e-3`` (a count on the
  block's absmax element), masters within ``2e-5`` absolute at
  ``lr=1e-2`` (a count of a moment moves an update by a fraction of lr
  over 127).
- step modes over the tiny Llama, 3 steps at ``lr=1e-2``: losses
  ``rtol=1e-5``.  The grads agree to fp32 rounding and are then rounded
  to bf16, where a tie may land one bf16 ulp (2^-8) apart and move that
  element's Adam step by about as much of lr; so at most 0.1 % of the
  masters' elements may differ by more than ``1e-5`` and none by more
  than ``STEPS * lr * 2^-5`` (measured: 0.07 % and 2.0e-4 at most).
  The chunked path with ``micro_steps=2`` allows 5 % (measured 2.5 %,
  3.5e-4 at most): JAX's chunked step has an accumulator of its own,
  which XLA compiles into the backward's program (``(acc +
  g).astype(bf16)`` rounds the fp32 grad once), where every mode of the
  port takes ``make_accumulated_grads_fn`` (the accumulator of JAX's
  fused steps), which rounds ``g`` to bf16 first.
- the bf16 mean of two microbatches' grads against JAX's (unjitted, as
  its fused step traces it): at most 0.5 % of a leaf's elements differ,
  each by at most 2^-8 of the leaf's largest |grad| (measured 0.15 %
  and 0.0011).
- modes of the port against each other (grouped against one group, the
  switches that must not change a number) are exact or ``atol=1e-6``;
  delayed against the synchronous steps on the shifted grads
  ``atol=1e-5``, the reference's own limit: the fused path computes its
  bias correction in fp32 (``1 - 0.999`` is 1.3e-5 off in fp32), the
  chunked one in float64 then fp32.
"""

import importlib
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
from dlrover_tpu_torch.observability import events as tev  # noqa: E402
from dlrover_tpu_torch.optimizers import host_offload as tho  # noqa: E402
from dlrover_tpu_torch.optimizers import (  # noqa: E402
    HostOffloadAdamW,
    offload_state_from_jax,
)

jho = importlib.import_module("dlrover_tpu.optimizers.host_offload")

LR, WD = 1e-2, 0.01


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, list):
        return np.concatenate([np.asarray(c, np.float32).reshape(-1)
                               for c in x])
    return np.asarray(x, np.float32)


def _jopt(**kw):
    return jho.HostOffloadAdamW(backend="numpy", **kw)


def _topt(**kw):
    return HostOffloadAdamW(device="cpu", **kw)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(3000).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "m": rng.standard_normal((13, 110)).astype(np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _grads(params, i, rng):
    return {k: (0.1 * v + 0.01 * (i + 1) * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in params.items()}


def _payload_readings(jmu, tmu):
    """(share of payload counts differing, largest count apart, largest
    relative scale difference) over a leaf's int8 chunks."""
    diff = total = 0
    worst = 0
    srel = 0.0
    for (jq, js), (tq, ts) in zip(jmu, tmu):
        a = np.asarray(jq, np.int32)
        b = tq.numpy().astype(np.int32)
        diff += int(np.sum(a != b))
        total += a.size
        worst = max(worst, int(np.max(np.abs(a - b))) if a.size else 0)
        ja = np.asarray(js, np.float32)
        srel = max(srel, float(np.max(np.abs(ja - ts.numpy())
                                      / np.maximum(np.abs(ja), 1e-30))))
    return diff / max(total, 1), worst, srel


def _bf16_ulp_ok(params, master):
    """Each bf16 param within one bf16 ulp of its fp32 master."""
    p, m = _np(params), _np(master)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(m), 1e-30))) - 7)
    return bool(np.all(np.abs(p - m) <= ulp))


# ------------------------------------------------------- apply_gradients


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("chunk", [1 << 20, 2048, 1000])
def test_apply_gradients_matches_jax(moments, chunk):
    """5 steps of ``apply_gradients`` on the same seeded grads; ``b`` (7
    elements) is a leaf smaller than one block, chunk 2048 splits ``w``
    and ``m``, chunk 1000 is not a whole number of blocks."""
    params = _tree(0)
    kw = dict(learning_rate=LR, weight_decay=WD, chunk_elems=chunk,
              moments=moments)
    jopt, topt = _jopt(**kw), _topt(**kw)
    js = jopt.init({k: v.copy() for k, v in params.items()})
    ts = topt.init(_torch_tree(params))
    rng = np.random.default_rng(1)
    for i in range(5):
        g = _grads(params, i, rng)
        js = jopt.apply_gradients(js, {k: jnp.asarray(v)
                                       for k, v in g.items()})
        ts = topt.apply_gradients(ts, _torch_tree(g))
    assert ts.step == js.step == 5
    for k in params:
        atol = 5e-7 if moments == "fp32" else 2e-5
        np.testing.assert_allclose(_np(ts.master[k]), _np(js.master[k]),
                                   rtol=2e-5, atol=atol)
        assert ts.params[k].dtype == torch.bfloat16
        assert _bf16_ulp_ok(ts.params[k], ts.master[k])
        if moments == "int8":
            n_chunks = len(topt._chunk_slices(params[k].size))
            assert len(ts.mu[k]) == len(js.mu[k]) == n_chunks
            for (jq, jsc), (tq, tsc) in zip(js.mu[k], ts.mu[k]):
                assert tuple(tq.shape) == np.shape(jq)
                assert tuple(tsc.shape) == np.shape(jsc)
            for jm, tm in ((js.mu[k], ts.mu[k]), (js.nu[k], ts.nu[k])):
                share, worst, srel = _payload_readings(jm, tm)
                assert share <= 0.01 and worst <= 1 and srel <= 1e-3, (
                    k, share, worst, srel)
        else:
            np.testing.assert_allclose(_np(ts.mu[k]), _np(js.mu[k]),
                                       rtol=2e-5, atol=1e-7)
            np.testing.assert_allclose(_np(ts.nu[k]), _np(js.nu[k]),
                                       rtol=2e-5, atol=1e-9)


def test_state_is_host_memory_updated_in_place():
    opt = _topt(learning_rate=LR, chunk_elems=64)
    state = opt.init({"w": torch.ones(500)})
    buf_m, buf_mu = state.master["w"], state.mu["w"]
    assert buf_m.device.type == "cpu" and buf_m.dtype == torch.float32
    s2 = opt.apply_gradients(state, {"w": torch.ones(500)})
    assert s2.master["w"] is buf_m and s2.mu["w"] is buf_mu
    assert not torch.equal(buf_m, torch.ones(500))
    assert s2.step == 1


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_checkpoint_roundtrip(moments):
    """A state cloned tensor by tensor restores to the same next step."""
    opt = _topt(learning_rate=LR, chunk_elems=1000, moments=moments)
    state = opt.init(_torch_tree(_tree(2)))
    g = _torch_tree(_grads(_tree(2), 0, np.random.default_rng(3)))
    state = opt.apply_gradients(state, g)
    clone = tho.OffloadState(
        step=state.step,
        params=jax.tree_util.tree_map(torch.clone, state.params),
        master=jax.tree_util.tree_map(torch.clone, state.master),
        mu=jax.tree_util.tree_map(torch.clone, state.mu),
        nu=jax.tree_util.tree_map(torch.clone, state.nu))
    restored = opt.pin_state(clone)
    s1 = opt.apply_gradients(state, g)
    s2 = opt.apply_gradients(restored, g)
    for k in s1.master:
        assert torch.equal(s1.master[k], s2.master[k])
        assert torch.equal(s1.params[k], s2.params[k])
    assert s2.step == 2


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("layout", ["numpy", "fused"])
def test_state_from_jax_carries_across(moments, layout):
    """Two JAX steps, the state carried across, a third step on both
    sides: the numpy backend's whole leaves and the fused state's chunk
    lists (fp32 chunks concatenated)."""
    params = _tree(4)
    kw = dict(learning_rate=LR, weight_decay=WD, chunk_elems=2048,
              moments=moments)
    jopt = _jopt(**kw)
    rng = np.random.default_rng(5)
    gs = [_grads(params, i, rng) for i in range(3)]
    js = jopt.init({k: v.copy() for k, v in params.items()})
    if layout == "fused":
        js = jopt._init_pinned({k: v.copy() for k, v in params.items()})
        assert isinstance(js.master["w"], list)
        ref = _jopt(**kw)
        rs = ref.init({k: v.copy() for k, v in params.items()})
    for g in gs[:2]:
        if layout == "fused":
            # the pinned layout takes its steps through the numpy
            # backend's math on a copy; carry that state's chunks over
            rs = ref.apply_gradients(rs, {k: jnp.asarray(v)
                                          for k, v in g.items()})
        else:
            js = jopt.apply_gradients(js, {k: jnp.asarray(v)
                                           for k, v in g.items()})
    if layout == "fused":
        slices = {k: jopt._chunk_slices(params[k].size) for k in params}
        js = js._replace(
            step=rs.step, params=rs.params,
            master={k: [rs.master[k].reshape(-1)[sl] for sl in slices[k]]
                    for k in params},
            mu=rs.mu if moments == "int8" else {
                k: [rs.mu[k].reshape(-1)[sl] for sl in slices[k]]
                for k in params},
            nu=rs.nu if moments == "int8" else {
                k: [rs.nu[k].reshape(-1)[sl] for sl in slices[k]]
                for k in params})
        jopt = ref
        js_next = rs
    else:
        js_next = js
    topt = _topt(**kw)
    ts = offload_state_from_jax(js, topt)
    assert ts.step == 2
    for k in params:
        np.testing.assert_array_equal(_np(ts.master[k]).reshape(-1),
                                      _np(js.master[k]).reshape(-1))
        np.testing.assert_array_equal(_np(ts.params[k]), _np(js.params[k]))
    ts = topt.apply_gradients(ts, _torch_tree(gs[2]))
    js_next = jopt.apply_gradients(js_next, {k: jnp.asarray(v)
                                             for k, v in gs[2].items()})
    for k in params:
        np.testing.assert_allclose(_np(ts.master[k]),
                                   _np(js_next.master[k]), rtol=2e-5,
                                   atol=5e-7 if moments == "fp32" else 2e-5)


def test_state_from_jax_rejects_another_chunking():
    params = _tree(6)
    jopt = _jopt(learning_rate=LR, chunk_elems=1000, moments="int8")
    js = jopt.init({k: v.copy() for k, v in params.items()})
    with pytest.raises(ValueError, match="chunk_elems"):
        offload_state_from_jax(js, _topt(chunk_elems=2048, moments="int8"))


def test_no_card_no_cpu_fallback():
    """Without a card an optimizer that was not asked for the CPU
    raises; it never drifts onto the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HostOffloadAdamW()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tho.build_offloaded_train_step(lambda p, b: 0.0, lambda r: {})


# ------------------------------------------------ switches and the span


def _spans(path):
    return [e for e in tev.read_events(str(path))
            if e["name"] == "offload_copy"]


@pytest.mark.parametrize("buffered", ["1", "0"])
def test_offload_copy_span_and_buffered_switch(tmp_path, monkeypatch,
                                               buffered):
    """One ``offload_copy`` span per streamed update with the reference's
    labels and bytes; ``BUFFERED=0`` tags it so and changes no number
    (rolling window, one-shot window and no prefetch all agree)."""
    monkeypatch.setenv(tho.OFFLOAD_BUFFERED_ENV, buffered)
    params = _tree(7)
    kw = dict(learning_rate=LR, chunk_elems=1000)
    g = _grads(params, 0, np.random.default_rng(8))
    jopt = _jopt(**kw)
    js = jopt.init({k: v.copy() for k, v in params.items()})
    path = tmp_path / "timeline.jsonl"
    jev = importlib.import_module("dlrover_tpu.observability.events")
    jev.set_default_event_logger(jev.EventLogger(path=str(tmp_path /
                                                           "jax.jsonl")))
    try:
        jopt.apply_gradients(js, {k: jnp.asarray(v) for k, v in g.items()},
                             prefetched=jopt.start_prefetch(js))
    finally:
        jev.set_default_event_logger(None)
    jspan = [e for e in jev.read_events(str(tmp_path / "jax.jsonl"))
             if e["name"] == "offload_copy"][-1]
    tev.set_default_event_logger(tev.EventLogger(path=str(path)))
    try:
        topt = _topt(**kw)
        s_pre = topt.init(_torch_tree(params))
        pre = topt.start_prefetch(s_pre)
        assert len(pre) <= topt.max_in_flight
        assert isinstance(pre, tho._RollingPrefetch) == (buffered == "1")
        s_pre = topt.apply_gradients(s_pre, _torch_tree(g), prefetched=pre)
        s_none = topt.apply_gradients(topt.init(_torch_tree(params)),
                                      _torch_tree(g))
    finally:
        tev.set_default_event_logger(None)
    for k in params:
        assert torch.equal(s_pre.master[k], s_none.master[k])
    spans = _spans(path)
    assert len(spans) == 2
    labels = spans[0]["labels"]
    assert set(labels) >= {"bytes", "throughput_gbps", "buffered"}
    assert labels["bytes"] == jspan["labels"]["bytes"] > 0
    assert labels["throughput_gbps"] > 0
    assert labels["buffered"] is (buffered == "1")
    assert jspan["labels"]["buffered"] is (buffered == "1")
    assert spans[1]["labels"]["buffered"] is False  # no prefetch


def test_quantized_wire_host_side_matches_numpy_mirror():
    """The quantized wire's host quantize and dequantize against the
    reference's ``_np_quant_chunk`` / ``_np_deq_chunk``, bit for bit,
    over ragged sizes, an all-zero block and the half-way block."""
    rng = np.random.default_rng(9)
    half = np.zeros(1024, np.float32)
    half[:8] = [127.0, 0.5, 2.5, 126.5, -0.5, -2.5, -126.5, 1.5]
    cases = [rng.standard_normal(n).astype(np.float32)
             for n in (1, 1000, 1024, 2100)]
    cases += [np.zeros(2048, np.float32), half]
    for x in cases:
        jq, js = jho._np_quant_chunk(x)
        tq, ts = tho._host_quant_chunk(torch.from_numpy(x.copy()))
        np.testing.assert_array_equal(tq.numpy(), jq)
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(
            tho._host_deq_chunk(tq, ts, x.size).numpy(),
            jho._np_deq_chunk(jq, js, x.size))


def test_quantized_wire_switch(monkeypatch):
    """``QUANT=1`` on the CPU: fp32 moments cross quantized (host state
    stays fp32, updated in place) and track JAX's quantized wire; unset
    and ``=0`` are the fp32 wire, equal to each other exactly; the
    staged window keeps its arity when the switch flips before the
    update."""
    params = _tree(10)
    kw = dict(learning_rate=LR, chunk_elems=1000)
    rng = np.random.default_rng(11)
    gs = [_grads(params, i, rng) for i in range(3)]

    def run_t(env, flip=None):
        if env is None:
            monkeypatch.delenv(tho.OFFLOAD_QUANT_ENV, raising=False)
        else:
            monkeypatch.setenv(tho.OFFLOAD_QUANT_ENV, env)
        opt = _topt(**kw)
        s = opt.init(_torch_tree(params))
        for g in gs:
            pre = opt.start_prefetch(s)
            if flip is not None:
                monkeypatch.setenv(tho.OFFLOAD_QUANT_ENV, flip)
            s = opt.apply_gradients(s, _torch_tree(g), prefetched=pre)
            if flip is not None:
                monkeypatch.setenv(tho.OFFLOAD_QUANT_ENV, env)
        return s

    unset, off, on = run_t(None), run_t("0"), run_t("1")
    flipped = run_t("1", flip="0")
    monkeypatch.setenv(tho.OFFLOAD_QUANT_ENV, "1")
    jopt = _jopt(**kw)
    js = jopt.init({k: v.copy() for k, v in params.items()})
    for g in gs:
        js = jopt.apply_gradients(js, {k: jnp.asarray(v)
                                       for k, v in g.items()})
    for k in params:
        assert torch.equal(unset.master[k], off.master[k])
        assert torch.equal(unset.nu[k], off.nu[k])
        assert on.mu[k].dtype == torch.float32
        assert torch.equal(flipped.master[k], on.master[k])
        assert not torch.equal(on.mu[k], off.mu[k])
        np.testing.assert_allclose(_np(on.master[k]), _np(js.master[k]),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(on.mu[k]), _np(js.mu[k]),
                                   rtol=1e-2, atol=1e-6)


# ------------------------------------------------- step modes, tiny Llama

STEPS = 3
GROUPED_STEPS = 2


def _llama(n_layers=2):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat="none",
                               n_layers=n_layers)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="none",
                               n_layers=n_layers)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    return jcfg, tcfg, npp, tokens


def _jbatch(tokens):
    return {"tokens": jnp.asarray(tokens)}


def _tbatch(tokens):
    return {"tokens": torch.from_numpy(tokens.astype(np.int64))}


def _tparams(npp):
    return params_from_jax(npp, device="cpu", dtype=torch.float32)


def _masters(state):
    return {"/".join(path): _np(v) for path, v in _named(state.master)}


def _named(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, prefix + (k,))
    else:
        yield prefix, tree


def _jmasters(state):
    out = {}
    for path, v in _named(state.master):
        out["/".join(path)] = _np(v).reshape(-1)
    return out


def _close_masters(tstate, jstate, share):
    """At most ``share`` of the masters' elements more than 1e-5 apart,
    none more than ``STEPS * LR * 2^-5``."""
    got = {k: v.reshape(-1) for k, v in _masters(tstate).items()}
    want = _jmasters(jstate)
    assert set(got) == set(want)
    d = np.concatenate([np.abs(got[k] - want[k]) for k in got])
    assert np.mean(d > 1e-5) <= share, np.mean(d > 1e-5)
    assert d.max() <= STEPS * LR * 2 ** -5, d.max()


def _run_modes(mode, moments, micro=1):
    jcfg, tcfg, npp, tokens = _llama()
    kw = dict(learning_rate=LR, weight_decay=WD, moments=moments)
    if mode == "chunked":
        jinit, jstep = jho.build_offloaded_train_step(
            lambda p, b: jl.loss_fn(p, b, jcfg), lambda r: npp,
            _jopt(**kw), mode="chunked", micro_steps=micro)
    else:
        jinit, jstep = jho.build_fused_offload_step(
            lambda p, b: jl.loss_fn(p, b, jcfg), lambda r: npp,
            jho.HostOffloadAdamW(**kw), delayed=(mode == "fused_delayed"),
            micro_steps=micro)
    tinit, tstep = tho.build_offloaded_train_step(
        lambda p, b: tl.loss_fn(p, b, tcfg), lambda r: _tparams(npp),
        _topt(**kw), mode=mode, micro_steps=micro)
    js, ts = jinit(jax.random.PRNGKey(0)), tinit(0)
    jl_, tl_ = [], []
    for _ in range(STEPS):
        js, jm = jstep(js, _jbatch(tokens))
        ts, tm = tstep(ts, _tbatch(tokens))
        jl_.append(float(jm["loss"]))
        tl_.append(float(tm["loss"]))
    return js, ts, jl_, tl_


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("mode,micro", [("chunked", 1), ("fused", 1),
                                        ("fused_delayed", 1),
                                        ("chunked", 2),
                                        ("fused_delayed", 2)])
def test_step_modes_match_jax(mode, micro, moments):
    js, ts, jloss, tloss = _run_modes(mode, moments, micro)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert int(ts.step) == int(js.step) == STEPS
    _close_masters(ts, js, 0.05 if (mode, micro) == ("chunked", 2)
                   else 1e-3)
    for (_, p), (_, m) in zip(_named(ts.params), _named(ts.master)):
        assert p.dtype == torch.bfloat16 and _bf16_ulp_ok(p, m)


def test_auto_mode_and_bad_mode():
    loss = lambda p, b: (p["w"].float() * b["x"]).pow(2).mean()  # noqa
    init = lambda r: {"w": torch.ones(8)}  # noqa: E731
    i_auto, _ = tho.build_offloaded_train_step(loss, init, _topt())
    assert isinstance(i_auto(0), tho.OffloadState)
    i_fused, _ = tho.build_offloaded_train_step(loss, init, _topt(),
                                                mode="fused_delayed")
    assert isinstance(i_fused(0), tho.FusedOffloadState)
    with pytest.raises(ValueError, match="mode"):
        tho.build_offloaded_train_step(loss, init, _topt(), mode="bogus")


def _toy():
    n = 320
    target = torch.linspace(-2.0, 2.0, n)

    def loss(p, b):
        return ((p["w"].float() * b["x"] - target) ** 2).mean()

    w0 = torch.from_numpy(
        np.random.default_rng(13).standard_normal(n).astype(np.float32))
    return loss, (lambda r: {"w": w0.clone()}), n


@pytest.mark.parametrize("micro", [1, 4])
def test_delayed_is_sync_on_shifted_grads(micro):
    """T delayed steps land where T-1 synchronous ``apply_gradients`` on
    the recorded grads land, weight decay included; step 1 moves
    nothing (its update is a no-op).  With ``micro_steps=4`` the recorded
    grads are the bf16 mean of the microbatches' grads."""
    loss, init, n = _toy()
    kw = dict(learning_rate=0.05, weight_decay=0.01, chunk_elems=100)
    istep, step = tho.build_fused_offload_step(
        loss, init, _topt(**kw), delayed=True, micro_steps=micro)
    state = istep(0)
    m0 = state.master["w"].clone()
    batch = {"x": torch.ones(n * micro)} if micro > 1 else {
        "x": torch.ones(n)}
    seen = []
    for t in range(4):
        state, _ = step(state, batch)
        seen.append({"w": state.grads["w"].float().clone()})
        if t == 0:
            assert torch.equal(state.master["w"], m0)
    ref = _topt(**kw)
    rs = ref.init(init(0))
    for g in seen[:-1]:
        rs = ref.apply_gradients(rs, g)
    np.testing.assert_allclose(_np(state.master["w"]), _np(rs.master["w"]),
                               rtol=0, atol=1e-5)


def test_micro_accumulation_is_the_mean_of_microbatch_grads():
    """``make_accumulated_grads_fn`` against the JAX one on the tiny
    Llama (one layer: the JAX side runs op by op): loss ``rtol=1e-5``;
    the bf16 mean grads as stated above."""
    jcfg, tcfg, npp, tokens = _llama(1)
    toks = np.concatenate([tokens, tokens[::-1]])
    jfn = jho.make_accumulated_grads_fn(
        lambda p, b: jl.loss_fn(p, b, jcfg), 2)
    tfn = tho.make_accumulated_grads_fn(
        lambda p, b: tl.loss_fn(p, b, tcfg), 2)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    tp = params_from_jax(npp, device="cpu", dtype=torch.bfloat16)
    jloss, jg = jfn(jp, _jbatch(toks))
    tloss, tg = tfn(tp, _tbatch(toks))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for (path, a), (_, b) in zip(_named(tg), _named(
            jax.tree_util.tree_map(np.asarray, jg))):
        got, want = _np(a), np.asarray(b, np.float32)
        assert a.dtype == torch.bfloat16 and got.shape == want.shape
        d = np.abs(got - want)
        assert np.mean(d > 0) <= 5e-3, path
        assert d.max() <= 2 ** -8 * np.abs(want).max(), path


# ---------------------------------------------------------------- grouped


def _split_parts(tree, boundaries, n_layers):
    bounds = [0, *boundaries, n_layers]
    parts = []
    for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        part = {"layers": {k: v[lo:hi] for k, v in tree["layers"].items()}}
        if i == 0:
            part["embed"] = tree["embed"]
        if i == len(bounds) - 2:
            part["final_norm"] = tree["final_norm"]
            part["lm_head"] = tree["lm_head"]
        parts.append(part)
    return parts


_ONE_GROUP = {}


def _one_group_runs(L):
    """The one-group chunked runs both grouped cases are held against,
    computed once: JAX's and the port's, ``GROUPED_STEPS`` steps each."""
    if L not in _ONE_GROUP:
        jcfg, tcfg, npp, tokens = _llama(L)
        kw = dict(learning_rate=LR, weight_decay=WD)
        jinit, jstep = jho.build_offloaded_train_step(
            lambda p, b: jl.loss_fn(p, b, jcfg), lambda r: npp,
            _jopt(**kw), mode="chunked")
        oinit, ostep = tho.build_offloaded_train_step(
            lambda p, b: tl.loss_fn(p, b, tcfg), lambda r: _tparams(npp),
            _topt(**kw), mode="chunked")
        js, os_ = jinit(jax.random.PRNGKey(0)), oinit(0)
        jloss, oloss = [], []
        for _ in range(GROUPED_STEPS):
            js, jm = jstep(js, _jbatch(tokens))
            os_, om = ostep(os_, _tbatch(tokens))
            jloss.append(float(jm["loss"]))
            oloss.append(float(om["loss"]))
        _ONE_GROUP[L] = (js, os_, jloss, oloss)
    return _ONE_GROUP[L]


@pytest.mark.parametrize("boundaries", [(2,), (1, 3)])
def test_grouped_matches_one_group(boundaries):
    """N = 2 and 3 groups over a 4-layer tiny Llama: every group's
    grads at the step-start params, so each step's loss and the masters
    equal the port's one-group chunked run's (the same backward, grads
    of a subset: losses ``rtol=1e-6``, masters ``atol=1e-6``), and JAX's
    one-group run's (losses ``rtol=1e-5``, masters ``atol=STEPS * lr *
    2^-5``, the tie limit above), which the reference holds its grouped
    step to."""
    L = 4
    _, tcfg, npp, tokens = _llama(L)
    js, one, jloss, oloss = _one_group_runs(L)
    kw = dict(learning_rate=LR, weight_decay=WD)
    tparts = [_tparams(p) for p in _split_parts(npp, boundaries, L)]
    tinit, tstep = tho.build_grouped_offload_step(
        lambda *a: tl.loss_fn_ngrouped(a[:-1], a[-1], tcfg),
        init_fns=[lambda p=p: p for p in tparts],
        optimizers=[_topt(**kw) for _ in tparts])
    ts = tinit(None)
    assert len(ts) == len(boundaries) + 1
    for t in range(GROUPED_STEPS):
        ts, tm = tstep(ts, _tbatch(tokens))
        np.testing.assert_allclose(float(tm["loss"]), jloss[t], rtol=1e-5)
        np.testing.assert_allclose(float(tm["loss"]), oloss[t], rtol=1e-6)
    assert all(s.step == GROUPED_STEPS for s in ts)
    bounds = [0, *boundaries, L]
    tie = STEPS * LR * 2 ** -5
    for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        for k, v in ts[i].master["layers"].items():
            np.testing.assert_allclose(
                _np(v), _np(one.master["layers"][k][lo:hi]), rtol=0,
                atol=1e-6, err_msg=k)
            np.testing.assert_allclose(
                _np(v), np.asarray(js.master["layers"][k][lo:hi]), rtol=0,
                atol=tie, err_msg=k)
    for i, k in ((0, "embed"), (-1, "final_norm"), (-1, "lm_head")):
        np.testing.assert_allclose(_np(ts[i].master[k]),
                                   _np(one.master[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(ts[i].master[k]),
                                   np.asarray(js.master[k]), rtol=0,
                                   atol=tie)


def test_grouped_two_group_convention_and_validation():
    L = 2
    _, tcfg, npp, tokens = _llama(L)
    a, b = (_tparams(p) for p in _split_parts(npp, (1,), L))
    kw = dict(learning_rate=LR, chunk_elems=4096)
    init, step = tho.build_grouped_offload_step(
        lambda pa, pb, batch: tl.loss_fn_grouped(pa, pb, batch, tcfg),
        lambda: a, lambda: b, _topt(**kw), _topt(**kw))
    st = init()
    assert len(st) == 2
    st, m = step(st, _tbatch(tokens))
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="at least one"):
        tho.build_grouped_offload_step(lambda b: 0.0, init_fns=[])
    with pytest.raises(ValueError, match="optimizers"):
        tho.build_grouped_offload_step(
            lambda a, b: 0.0, init_fns=[lambda: {}, lambda: {}],
            optimizers=[_topt()])
    with pytest.raises(ValueError, match="optimizers"):
        tho.build_grouped_offload_step(
            lambda a, b: 0.0, init_fns=[lambda: {}, lambda: {}],
            optimizers=[])


def test_init_ngrouped_params_layout_and_validation():
    cfg = tl.LlamaConfig.tiny(n_layers=5)
    fns = tl.init_ngrouped_params(cfg, (2, 3), device="cpu")
    parts = [f() for f in fns]
    assert [set(p) for p in parts] == [{"embed", "layers"}, {"layers"},
                                       {"layers", "final_norm", "lm_head"}]
    assert [p["layers"]["wq"].shape[0] for p in parts] == [2, 1, 2]
    assert all(p["layers"]["wq"].dtype == torch.float32 for p in parts)
    a, b = tl.init_grouped_params(cfg, 1, device="cpu")
    assert a()["layers"]["wq"].shape[0] == 1
    assert b()["layers"]["wq"].shape[0] == 4
    for bad in ((3, 2), (0, 2), (2, 5), (2, 2)):
        with pytest.raises(ValueError, match="strictly increasing"):
            tl.init_ngrouped_params(cfg, bad, device="cpu")
    # JAX validates the same splits
    for bad in ((3, 2), (2, 2)):
        with pytest.raises(ValueError, match="strictly increasing"):
            jl.init_ngrouped_params(jax.random.PRNGKey(0),
                                    jl.LlamaConfig.tiny(n_layers=5), bad)


def test_segmented_layer_stack_is_the_whole_stack():
    """A tuple of stacked layer trees runs as sequential segments: the
    loss over the 3-way split equals the loss over the whole tree."""
    _, tcfg, npp, tokens = _llama(4)
    tp = _tparams(npp)
    parts = [_tparams(p) for p in _split_parts(npp, (1, 3), 4)]
    whole = tl.loss_fn(tp, _tbatch(tokens), tcfg)
    split = tl.loss_fn_ngrouped(parts, _tbatch(tokens), tcfg)
    assert torch.equal(whole, split)


def test_offload_group_plan_wires_the_solver():
    """``offload_group_plan`` picks more than one group for 7B width at
    a budget the one-group peak exceeds, and its boundaries build."""
    cfg = tl.LlamaConfig.llama2_7b(n_layers=32)
    plan = tl.offload_group_plan(cfg, batch=4, seq=2048,
                                 hbm_bytes=24 * 2 ** 30)
    assert plan.n_groups >= 2
    assert len(plan.boundaries) == plan.n_groups - 1
    assert list(plan.boundaries) == sorted(set(plan.boundaries))
    one = tl.offload_group_plan(cfg, batch=4, seq=2048,
                                hbm_bytes=80 * 2 ** 30)
    assert one.n_groups <= plan.n_groups
