"""The port's LR schedules and WSAM against the JAX package, on the CPU.

- every schedule name of ``dlrover_tpu_torch.optimizers.schedules``
  against ``dlrover_tpu.optimizers.schedules`` (optax) at steps 0 to
  ``total + 5``, with and without warmup, and the options each name
  takes; the registry and its errors;
- ``wsam_gradients`` coupled and decoupled, plain and adaptive, and
  ``wsam_apply_sharpness``, against the JAX functions on the same seeded
  params, batch and a quadratic-plus-tanh loss;
- the ``Trainer``'s ``lr`` record: step N's record holds ``schedule(N -
  1)``, the value the reference's trainer logs.

Tolerances.  Schedules: ``|port - optax| <= 1e-6 * peak lr`` (optax
computes in float32, the port in float64; near the end of a cosine the
float32 ``1 + cos`` cancels to ~1e-5 relative, so the limit is on the
peak, not on the value).  WSAM: losses ``rtol=1e-6``, grads ``rtol=1e-5,
atol=1e-6`` (fp32 sums in another order; the perturbation's norm is one
global fp32 sum).
"""

import importlib
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu_torch.optimizers import (  # noqa: E402
    available_schedulers,
    get_scheduler,
    wsam_apply_sharpness,
    wsam_gradients,
)

jsched = importlib.import_module("dlrover_tpu.optimizers.schedules")
jwsam = importlib.import_module("dlrover_tpu.optimizers.wsam")

LR = 3e-4
TOTAL = 40

CASES = [
    ("constant", {}),
    ("constant_with_warmup", {}),
    ("linear", {}),
    ("linear", {"end_value": 1e-5}),
    ("cosine", {}),
    ("cosine_with_min_lr", {}),
    ("cosine_with_min_lr", {"min_lr_ratio": 0.3}),
    ("polynomial", {}),
    ("polynomial", {"power": 2.0, "end_value": 1e-6}),
    ("inverse_sqrt", {}),
    ("wsd", {}),
    ("wsd", {"decay_ratio": 0.25, "min_lr_ratio": 0.1}),
]


def test_registry_names_match_the_reference():
    assert available_schedulers() == jsched.available_schedulers()
    assert len(available_schedulers()) == 8


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("name,kw", CASES)
def test_schedule_matches_optax_at_every_step(name, kw, warmup):
    port = get_scheduler(name, LR, total_steps=TOTAL, warmup_steps=warmup,
                         **kw)
    ref = jsched.get_scheduler(name, LR, total_steps=TOTAL,
                               warmup_steps=warmup, **kw)
    steps = np.arange(TOTAL + 6)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)), np.float64)
    got = np.array([port(int(s)) for s in steps])
    assert all(isinstance(port(int(s)), float) for s in steps[:3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * LR,
                               err_msg=f"{name} {kw} warmup={warmup}")
    if warmup:
        assert got[0] == 0.0 and got[warmup] == pytest.approx(
            want[warmup], abs=1e-6 * LR)


def test_scheduler_errors_match_the_reference():
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("nope", LR)
    for name in ("linear", "cosine", "cosine_with_min_lr", "polynomial",
                 "wsd"):
        with pytest.raises(ValueError, match="requires total_steps"):
            get_scheduler(name, LR)
        with pytest.raises(ValueError, match="requires total_steps"):
            jsched.get_scheduler(name, LR)
    assert get_scheduler("inverse_sqrt", LR)(0) == pytest.approx(LR)


# ------------------------------------------------------------------ WSAM


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    batch = {"x": rng.standard_normal((6, 8)).astype(np.float32),
             "y": rng.standard_normal((6, 5)).astype(np.float32)}
    return params, batch


def _jax_lag(params, batch):
    def loss(p, b):
        h = jnp.tanh(b["x"] @ p["w"] + p["b"])
        return jnp.mean((h - b["y"]) ** 2) + 0.01 * jnp.sum(p["w"] ** 2)

    return jax.value_and_grad(loss)(params, batch)


def _torch_lag(params, batch):
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    h = torch.tanh(batch["x"] @ p["w"] + p["b"])
    loss = torch.mean((h - batch["y"]) ** 2) + 0.01 * torch.sum(p["w"] ** 2)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("decouple", [True, False])
def test_wsam_gradients_match_jax(decouple, adaptive):
    params, batch = _problem()
    kw = dict(rho=0.05, gamma=0.9, adaptive=adaptive, decouple=decouple)
    jl, jg, js = jwsam.wsam_gradients(
        _jax_lag, {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg, ts = wsam_gradients(_torch_lag, tp, tb, **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-6)
        if not decouple:
            assert not ts[k].any()
    if decouple:
        jp = jwsam.wsam_apply_sharpness(
            {k: jnp.asarray(v) for k, v in params.items()}, js, 0.1, 0.9)
        tp2 = wsam_apply_sharpness(tp, ts, 0.1, 0.9)
        for k in params:
            np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)
            # a new tree: the params given are not written
            assert torch.equal(tp[k], torch.from_numpy(params[k]))


# ------------------------------------------------------- Trainer's lr


def test_trainer_records_the_lr_its_update_applied():
    """``Trainer(lr_schedule=...)``: step N's record holds
    ``schedule(N - 1)`` (optax reads the schedule before its count
    advances), as ``dlrover_tpu/trainer/trainer.py`` logs it; without a
    schedule the record has no ``lr``."""
    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="none")
    sched = get_scheduler("cosine", 1e-3, total_steps=4, warmup_steps=1)
    ref = jsched.get_scheduler("cosine", 1e-3, total_steps=4,
                               warmup_steps=1)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int64)

    def data():
        while True:
            yield {"tokens": tokens}

    def run(schedule):
        result = auto_accelerate(
            loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
            optimizer=lambda ps: AGD(ps, lr=1e-3),
            init_params_fn=lambda gen, dev: tl.init_params(
                cfg, gen, dev, dtype=torch.float32),
            device="cpu")
        trainer = Trainer(result, TrainingArgs(max_steps=4, log_interval=0),
                          data, lr_schedule=schedule)
        trainer.train()
        return trainer.history

    hist = run(sched)
    assert [r["step"] for r in hist] == [1, 2, 3, 4]
    for r in hist:
        assert r["lr"] == sched(r["step"] - 1)
        assert r["lr"] == pytest.approx(float(ref(r["step"] - 1)),
                                        abs=1e-9)
    assert hist[0]["lr"] == 0.0  # the warmup's first step
    assert all("lr" not in r for r in run(None))
