"""The port's strategy search against the JAX package's, on the CPU.

- ``generate_candidates`` and ``solver.resolve_for_world`` give the JAX
  functions' strategies on the same profiles (the analytic ranking,
  the memory fit, the global-batch filter, long context, the re-solve
  of a pinned strategy for another world); ``auto_accelerate`` without
  a dry run picks the JAX package's ``candidates[0]``, and a pinned
  strategy of another world is re-solved to the JAX package's plan
  (mirrors ``tests/test_accelerate.py``'s candidate and
  ``auto_accelerate`` cases).
- ``successive_halving`` with one scripted timer patched into both
  modules gives the same winner and timings; ``BayesOpt`` and
  ``tune_strategy`` suggest the same configs in the same order and pick
  the same best; ``CalibratedPlanner`` fits the same coefficients
  (1e-9) and ranks the same plans at 256 devices.
- The strategy service round-trips over the port's gRPC transport,
  learns from a reported measurement, tolerates version skew, serves the
  JAX service's candidates, and raises for a durable history (A3c.3a).
- The dry runner: a failed build is ``None`` and torn down, a kernel
  failure raises, the state does not outlive its timing, every
  candidate failing raises; at world 1 a dry run races, tunes and
  calibrates.
- Four gloo ranks (``tests/torch_search_worker.py``): one rank's slower
  timer moves every rank's verdict alike, a build failure on one rank
  is skipped on every rank, a layout the model's ``check_mesh`` refuses
  (two kv heads on tensor 4) is skipped on every rank, a rank late out
  of its warm-up is not timed by the others, a step failure raises on
  its rank and is not skipped, the race gives its process groups back,
  and the call without a dry run picks the JAX package's
  ``candidates[0]``.
"""

import dataclasses
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from dlrover_tpu.accelerate import analyser as janalyser  # noqa: E402
from dlrover_tpu.accelerate import api as japi  # noqa: E402
from dlrover_tpu.accelerate import bayes_search as jbayes  # noqa: E402
from dlrover_tpu.accelerate import dim_planner as jplanner  # noqa: E402
from dlrover_tpu.accelerate import engine_service as jservice  # noqa: E402
from dlrover_tpu.accelerate import search as jsearch  # noqa: E402
from dlrover_tpu.accelerate import solver as jsolver  # noqa: E402
from dlrover_tpu.accelerate import strategy as jstrategy  # noqa: E402
from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu_torch.accelerate import analyser as tanalyser  # noqa: E402
from dlrover_tpu_torch.accelerate import api as tapi  # noqa: E402
from dlrover_tpu_torch.accelerate import bayes_search as tbayes  # noqa: E402
from dlrover_tpu_torch.accelerate import dim_planner as tplanner  # noqa: E402
from dlrover_tpu_torch.accelerate import dry_runner  # noqa: E402
from dlrover_tpu_torch.accelerate import (  # noqa: E402
    engine_service as tservice,
)
from dlrover_tpu_torch.accelerate import search as tsearch  # noqa: E402
from dlrover_tpu_torch.accelerate import solver as tsolver  # noqa: E402
from dlrover_tpu_torch.accelerate import strategy as tstrategy  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.ops._build import KernelError  # noqa: E402
from dlrover_tpu_torch.optimizers import AGD  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
PLANNER_ATOL = 1e-9

#: ModelProfile fields: the 7B of tests/test_accelerate.py (bare, and
#: with its activation census and layers), a 1M model whose activations
#: need accumulation, a 1.3B and a 70B
PROFILES = {
    "7b": dict(num_params=7_000_000_000, param_bytes=28_000_000_000,
               largest_leaf=1, leaf_count=1, optimizer_bytes=56_000_000_000),
    "7b_acts": dict(num_params=7_000_000_000, param_bytes=28_000_000_000,
                    largest_leaf=1, leaf_count=100,
                    optimizer_bytes=56_000_000_000, num_layers=32,
                    activation_bytes_per_sample=32 * 7 * 2048 * 4096 * 2),
    "1m_acts": dict(num_params=1_000_000, param_bytes=4_000_000,
                    largest_leaf=100, leaf_count=4, optimizer_bytes=8_000_000,
                    num_layers=4, activation_bytes_per_sample=10 * (1 << 30)),
    "1b_acts": dict(num_params=1_300_000_000, param_bytes=5_200_000_000,
                    largest_leaf=1, leaf_count=100,
                    optimizer_bytes=10_400_000_000, num_layers=24,
                    activation_bytes_per_sample=24 * 7 * 2048 * 2048 * 2),
    "70b": dict(num_params=70_000_000_000, param_bytes=280_000_000_000,
                largest_leaf=1, leaf_count=80,
                optimizer_bytes=560_000_000_000, num_layers=80,
                activation_bytes_per_sample=80 * 7 * 4096 * 8192 * 2),
}
WORKLOADS = (
    dict(),
    dict(batch_per_replica=8),
    dict(global_batch=8),
    dict(global_batch=4, seq_len=16),
    dict(long_context=True, seq_len=32768),
)


def _d(s):
    return dataclasses.asdict(s)


def _profiles(name):
    return (janalyser.ModelProfile(**PROFILES[name]),
            tanalyser.ModelProfile(**PROFILES[name]))


def _tiny_profiles():
    jcfg = jl.LlamaConfig.tiny(remat="none")
    tcfg = tl.LlamaConfig.tiny(remat="none", dtype=torch.float32)
    from dlrover_tpu.optimizers.agd import agd

    jp = janalyser.analyse_model(lambda rng: jl.init_params(rng, jcfg),
                                 agd(1e-3))
    tp = tanalyser.analyse_model(
        lambda g, d: tl.init_params(tcfg, g, d, dtype=torch.float32),
        lambda ps: AGD(ps, lr=1e-3))
    return jp, tp


# --------------------------------------------------------- the candidates


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("n", [1, 2, 8, 16, 256])
@pytest.mark.parametrize("workload", range(len(WORKLOADS)))
def test_generate_candidates_equals_jax(name, n, workload):
    jp, tp = _profiles(name)
    kw = WORKLOADS[workload]
    want = [_d(s) for s in jstrategy.generate_candidates(jp, n, **kw)]
    got = [_d(s) for s in tstrategy.generate_candidates(tp, n, **kw)]
    assert got == want


def test_tiny_profile_and_candidates_equal_jax():
    jp, tp = _tiny_profiles()
    for f in ("num_params", "param_bytes", "largest_leaf", "leaf_count",
              "num_layers"):
        assert getattr(tp, f) == getattr(jp, f), f
    for n in (1, 2, 4, 8):
        for kw in (dict(), dict(global_batch=4, seq_len=16)):
            want = jstrategy.generate_candidates(jp, n, **kw)
            got = tstrategy.generate_candidates(tp, n, **kw)
            assert [_d(s) for s in got] == [_d(s) for s in want]
    # tests/test_accelerate.py: a tiny model on 8 devices is plain DP
    assert tstrategy.generate_candidates(tp, 8)[0].data == 8


@pytest.mark.parametrize("name", ["7b", "7b_acts", "70b"])
@pytest.mark.parametrize("prior,n", [
    (dict(data=2, fsdp=4), 4), (dict(fsdp=8), 16), (dict(data=2), 1),
    (dict(pipe=2, tensor=2, pipe_microbatches=8), 8),
    (dict(tensor=4, fsdp=2), 2)])
def test_resolve_for_world_equals_jax(name, prior, n):
    jp, tp = _profiles(name)
    kw = dict(batch_per_replica=1, seq_len=2048)
    try:
        want = jsolver.resolve_for_world(
            jp, n, prior=jstrategy.Strategy(**prior), **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tsolver.resolve_for_world(
                tp, n, prior=tstrategy.Strategy(**prior), **kw)
        return
    got = tsolver.resolve_for_world(
        tp, n, prior=tstrategy.Strategy(**prior), **kw)
    assert _d(got.strategy) == _d(want.strategy)
    assert got.describe() == want.describe()


def _jax_accelerate(n, **kw):
    jcfg = jl.LlamaConfig.tiny(remat="none")
    from dlrover_tpu.optimizers.agd import agd

    try:
        return japi.auto_accelerate(
            loss_fn=lambda p, b: jl.loss_fn(p, b, jcfg), optimizer=agd(1e-3),
            init_params_fn=lambda rng: jl.init_params(rng, jcfg),
            param_axes=jl.param_logical_axes(jcfg),
            devices=jax.devices()[:n], **kw).strategy
    finally:
        jmesh.destroy_parallel_mesh()


def _port_accelerate(**kw):
    tcfg = tl.LlamaConfig.tiny(remat="none", dtype=torch.float32)
    return tapi.auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, tcfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=lambda g, d: tl.init_params(tcfg, g, d,
                                                   dtype=torch.float32),
        param_axes=tl.param_logical_axes(tcfg), device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(), dict(global_batch=4, seq_len=16)])
def test_auto_accelerate_without_a_dry_run_picks_jax_candidates_0(kw):
    want = _jax_accelerate(1, **kw)
    got = _port_accelerate(**kw)
    assert _d(got.strategy) == _d(want)
    assert got.timings == {} and got.planner is None


def test_a_pinned_strategy_of_another_world_is_resolved_as_jax():
    pinned = dict(data=2, fsdp=2, num_micro_steps=2)
    want = _jax_accelerate(1, load_strategy=jstrategy.Strategy(**pinned))
    got = _port_accelerate(load_strategy=tstrategy.Strategy(**pinned))
    assert got.strategy.n_devices == 1
    assert _d(got.strategy) == _d(want)
    # a strategy of this world's size is kept as it is
    same = tstrategy.Strategy(num_micro_steps=2)
    assert _port_accelerate(load_strategy=same).strategy == same


def test_moe_and_expert_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        _port_accelerate(moe=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        _port_accelerate(load_strategy=tstrategy.Strategy(expert=2))


# ------------------------------------------------- the search's own logic


def _scripted(table):
    """A timer that reads ``table[(describe, steps)]`` (None: failed)."""
    def timer(build_fn, s, warmup=1, steps=3):
        return table[(s.describe(), steps)]
    return timer


def _same_timings(a, b):
    assert set(a) == set(b)
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            assert (math.isnan(x) and math.isnan(y)) or x == y, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_successive_halving_equals_jax_with_a_scripted_timer(
        seed, monkeypatch):
    jp, tp = _profiles("7b_acts")
    jc = jstrategy.generate_candidates(jp, 16, global_batch=32)
    tc = tstrategy.generate_candidates(tp, 16, global_batch=32)
    assert [_d(s) for s in jc] == [_d(s) for s in tc] and len(tc) >= 4
    rng = np.random.default_rng(seed)
    table = {}
    for s in tc:
        base = float(rng.uniform(0.5, 2.0))
        for steps in (1, 2, 4, 5):
            table[(s.describe(), steps)] = base + float(
                rng.normal(0, 0.05)) / steps
    # one candidate fails to build
    for steps in (1, 2, 4, 5):
        table[(tc[int(rng.integers(len(tc)))].describe(), steps)] = None
    monkeypatch.setattr(jsearch, "time_strategy", _scripted(table))
    monkeypatch.setattr(tsearch, "time_strategy", _scripted(table))
    jwin, jt = jsearch.successive_halving(lambda s: None, jc)
    twin, tt = tsearch.successive_halving(lambda s: None, tc)
    assert _d(twin) == _d(jwin)
    _same_timings(tt, jt)


def test_successive_halving_with_every_candidate_failing_is_none(
        monkeypatch):
    monkeypatch.setattr(tsearch, "time_strategy",
                        lambda *a, **k: None)
    cands = [tstrategy.Strategy(data=2), tstrategy.Strategy(fsdp=2)]
    win, timings = tsearch.successive_halving(lambda s: None, cands)
    assert win is None and all(math.isnan(t[0]) for t in timings.values())


SPACE = {"num_micro_steps": [1, 2, 4, 8], "pipe_microbatches": [2, 4, 8]}


def _cost(cfg):
    if cfg["num_micro_steps"] == 8 and cfg["pipe_microbatches"] == 2:
        return None  # a failed build
    m, p = math.log2(cfg["num_micro_steps"]), math.log2(
        cfg["pipe_microbatches"])
    return 1.0 + 0.3 * (m - 1.4) ** 2 + 0.2 * (p - 2.2) ** 2 + 0.01 * m * p


@pytest.mark.parametrize("seed", [0, 3])
def test_bayes_opt_suggests_the_jax_sequence(seed):
    jbo, tbo = jbayes.BayesOpt(SPACE, seed=seed), tbayes.BayesOpt(
        SPACE, seed=seed)
    seq = []
    for _ in range(10):
        jcfg, tcfg = jbo.suggest(), tbo.suggest()
        assert tcfg == jcfg
        seq.append(tcfg)
        jbo.observe(jcfg, _cost(jcfg))
        tbo.observe(tcfg, _cost(tcfg))
    assert tbo.best() == jbo.best()
    assert len({tuple(sorted(c.items())) for c in seq}) == 10
    # the surrogates over the whole grid
    for (mj, sj), (mt, st) in zip(_gp_over_grid(jbo, jbayes),
                                  _gp_over_grid(tbo, tbayes)):
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-12)


def test_expected_improvement_equals_jax():
    """The port's normal cdf (``math.erf``) against the reference's
    (scipy's ``erf``), over EI's whole working range, to 1e-15."""
    rng = np.random.default_rng(5)
    mean = rng.normal(1.0, 0.5, 512)
    std = rng.uniform(1e-6, 2.0, 512)
    z = np.linspace(-12.0, 12.0, 961)
    np.testing.assert_allclose(tbayes._phi_cdf(z), jbayes._phi_cdf(z),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        tbayes.expected_improvement(mean, std, 0.8),
        jbayes.expected_improvement(mean, std, 0.8), rtol=1e-13, atol=1e-15)


def _gp_over_grid(bo, module):
    """The mean and std of ``module``'s GP fitted on ``bo``'s
    observations, over the grid."""
    idx = sorted(bo._observed)
    gp = module.GaussianProcess()
    gp.fit(bo._embed[idx], np.array([bo._observed[i] for i in idx]))
    return [gp.predict(bo._embed)]


def test_tune_strategy_equals_jax():
    def time_fn(build_fn, s, **kw):
        return _cost({"num_micro_steps": s.num_micro_steps,
                      "pipe_microbatches": s.pipe_microbatches})

    jbest, jhist = jbayes.tune_strategy(
        None, jstrategy.Strategy(pipe=2, data=2), SPACE, budget=7,
        time_fn=time_fn)
    tbest, thist = tbayes.tune_strategy(
        None, tstrategy.Strategy(pipe=2, data=2), SPACE, budget=7,
        time_fn=time_fn)
    assert _d(tbest) == _d(jbest)
    assert list(thist.items()) == list(jhist.items())


def test_calibrated_planner_equals_jax():
    jp, tp = _profiles("1b_acts")
    jc = jstrategy.generate_candidates(jp, 8, global_batch=16)
    tc = tstrategy.generate_candidates(tp, 8, global_batch=16)
    rng = np.random.default_rng(11)
    times = [float(rng.uniform(0.5, 3.0)) for _ in tc]
    times[1] = float("nan")  # a failed candidate is left out of the fit
    jplan = jplanner.CalibratedPlanner(jp, batch_per_replica=2,
                                       seq_len=2048)
    tplan = tplanner.CalibratedPlanner(tp, batch_per_replica=2,
                                       seq_len=2048)
    jw = jplan.calibrate(list(zip(jc, times)))
    tw = tplan.calibrate(list(zip(tc, times)))
    np.testing.assert_allclose(tw, jw, rtol=0, atol=PLANNER_ATOL)
    for s, t in zip(tc, jc):
        np.testing.assert_allclose(
            tplanner.strategy_features(s, tp, 2, 2048),
            jplanner.strategy_features(t, jp, 2, 2048), rtol=0, atol=0)
    want = jplan.plan(n_devices=256, top_k=8)
    got = tplan.plan(n_devices=256, top_k=8)
    assert [_d(s) for s, _ in got] == [_d(s) for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-12, atol=0)


# ------------------------------------------------------ the service


def test_strategy_service_round_trip_and_learning():
    server, port = tservice.start_strategy_service()
    try:
        client = tservice.StrategyClient(f"127.0.0.1:{port}")
        _, big = _profiles("7b")
        cands = client.request_candidates(big, 8)
        assert cands
        for s in cands:
            assert s.fsdp * s.tensor * s.pipe >= 8
        # the JAX service's answer to the same request
        want = jservice.StrategyService().generate(jservice.StrategyRequest(
            num_params=big.num_params, param_bytes=big.param_bytes,
            optimizer_bytes=big.optimizer_bytes, n_devices=8))
        assert [_d(s) for s in cands] == want.candidates
        assert client.report_measurement(big, cands[0], step_time_s=1000.0)
        cands2 = client.request_candidates(big, 8)
        assert cands2 and cands2[0] != cands[0]
        client.close()
    finally:
        server.stop(0)


def test_strategy_service_learns_as_jax_does():
    req = dict(num_params=7_000_000_000, param_bytes=28_000_000_000,
               optimizer_bytes=56_000_000_000, num_layers=32, n_devices=16,
               activation_bytes_per_sample=32 * 7 * 2048 * 4096 * 2)
    jsvc, tsvc = jservice.StrategyService(), tservice.StrategyService()
    first = tsvc.generate(tservice.StrategyRequest(**req)).candidates
    assert first == jsvc.generate(jservice.StrategyRequest(**req)).candidates
    meas = {k: v for k, v in req.items() if k != "n_devices"}
    for i, kw in enumerate(first[:3]):
        for svc, mod in ((jsvc, jservice), (tsvc, tservice)):
            svc.record(mod.StrategyMeasurement(
                strategy=kw, step_time_s=10.0 - 3 * i, **meas))
    want = jsvc.generate(jservice.StrategyRequest(**req))
    got = tsvc.generate(tservice.StrategyRequest(**req))
    assert got.calibrated and want.calibrated
    assert got.candidates == want.candidates


def test_strategy_service_tolerates_version_skew():
    svc = tservice.StrategyService()
    svc.record(tservice.StrategyMeasurement(
        num_params=1000, num_layers=2,
        strategy={"data": 2, "future_field_not_in_this_build": 7},
        step_time_s=0.5))
    key = next(iter(svc._measurements))
    (s, t), = svc._measurements[key]
    assert s.data == 2 and t == 0.5
    # an unconstructible dict is dropped, not raised
    assert tservice._strategy_from_dict({"data": 2, "extras": 1,
                                         "bogus": 1}) is not None
    assert tservice._strategy_from_dict({"remat": []}) is not None


def test_strategy_service_respects_global_batch():
    resp = tservice.StrategyService().generate(tservice.StrategyRequest(
        num_params=1_000_000, param_bytes=4_000_000,
        optimizer_bytes=8_000_000, n_devices=8, global_batch=4))
    assert resp.candidates
    for kw in resp.candidates:
        assert 4 % (kw["data"] * kw["fsdp"]) == 0


def test_strategy_service_durable_history_raises(monkeypatch, tmp_path):
    """With ``DLROVER_TPU_BRAIN_DB`` set the service no longer raises: a
    fresh service reads the measurements its predecessor recorded and
    ranks as it did."""
    from dlrover_tpu_torch.master import datastore

    monkeypatch.setenv("DLROVER_TPU_BRAIN_DB", str(tmp_path / "brain.db"))
    monkeypatch.setattr(datastore, "_default_store", None)
    req = dict(num_params=1_000_000, param_bytes=4_000_000,
               optimizer_bytes=8_000_000, num_layers=4, n_devices=8)
    try:
        first = tservice.StrategyService()
        cands = first.generate(tservice.StrategyRequest(**req)).candidates
        meas = {k: v for k, v in req.items() if k != "n_devices"}
        for i, kw in enumerate(cands[:3]):
            first.record(tservice.StrategyMeasurement(
                strategy=kw, step_time_s=3.0 - i, **meas))
        want = first.generate(tservice.StrategyRequest(**req))
        again = tservice.StrategyService().generate(
            tservice.StrategyRequest(**req))
        assert again.calibrated and want.calibrated
        assert again.candidates == want.candidates
    finally:
        datastore._default_store.close()
        datastore._default_store = None


# ------------------------------------------------------- the dry runner


def test_a_failed_build_is_none_and_torn_down():
    calls = []

    def build(s):
        raise torch.cuda.OutOfMemoryError("planted")

    build.teardown = lambda: calls.append(1)
    assert dry_runner.time_strategy(build, tstrategy.Strategy()) is None
    assert calls == [1]


def test_a_kernel_failure_raises_and_is_not_a_failed_candidate():
    def build(s):
        raise KernelError("nvcc failed for flash_attention")

    with pytest.raises(KernelError):
        dry_runner.time_strategy(build, tstrategy.Strategy())
    # a step failure raises too, and nothing is torn down after it
    calls = []

    def step(state, batch):
        raise RuntimeError("planted step failure")

    def build_ok(s):
        return step, {}, {"tokens": torch.zeros(1, 2)}

    build_ok.teardown = lambda: calls.append(1)
    with pytest.raises(RuntimeError, match="planted step failure"):
        dry_runner.time_strategy(build_ok, tstrategy.Strategy())
    assert calls == []


def test_the_state_does_not_outlive_its_timing():
    refs, seen = [], []

    def step(state, batch):
        seen.append(len(refs))
        return state, {}

    def build(s):
        state = {"w": torch.ones(4)}
        refs.append(weakref.ref(state["w"]))
        return step, state, {"tokens": torch.zeros(1, 2)}

    build.teardown = lambda: seen.append("teardown")
    t = dry_runner.time_strategy(build, tstrategy.Strategy(), warmup=2,
                                 steps=3)
    assert t is not None and t >= 0
    assert refs[0]() is None
    assert seen == [1] * 5 + ["teardown"]


def test_every_candidate_failing_raises():
    def bad_batch(batch_sharding):
        raise ValueError("planted: no batch")

    with pytest.raises(RuntimeError, match="every candidate failed"):
        _port_accelerate(dry_run=True, sample_batch_fn=bad_batch)


def test_a_dry_run_at_world_one_races_tunes_and_calibrates():
    tokens = np.random.default_rng(2).integers(0, 256, (4, 17)).astype(
        np.int32)
    result = _port_accelerate(
        dry_run=True, global_batch=4, seq_len=16,
        sample_batch_fn=lambda bs: {"tokens": torch.from_numpy(
            bs.local({"tokens": tokens})["tokens"])},
        tune_space={"num_micro_steps": [1, 2]}, tune_budget=2)
    assert list(result.timings["single-device"]) and all(
        t > 0 for t in result.timings["single-device"])
    assert len(result.timings["bayes_tune"]) == 2
    assert result.planner is not None
    plans = result.planner.plan(n_devices=16, top_k=3)
    assert plans and all(s.n_devices == 16 for s, _ in plans)
    state = result.fns.init_state(0)
    _, m = result.fns.train_step(state, {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(m["loss"]))


# --------------------------------------------------- four gloo ranks


@pytest.fixture(scope="module")
def ranks():
    work = Path(tempfile.mkdtemp(prefix="dts", dir="/tmp"))
    try:
        port = get_free_port()
        procs = []
        for rank in range(WORLD):
            env = dict(os.environ, OMP_NUM_THREADS="1",
                       DLROVER_TPU_PROCESS_RANK=str(rank),
                       DLROVER_TPU_PROCESS_COUNT=str(WORLD),
                       DLROVER_TPU_LOCAL_RANK=str(rank),
                       DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                       PYTHONPATH=str(REPO))
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests/torch_search_worker.py"),
                 str(work)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=150)[0])
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        out = {"logs": outs, "rc": [p.returncode for p in procs]}
        for phase in ("slow", "build_fail", "plain", "late", "heads"):
            out[phase] = [torch.load(work / f"{phase}_rank{r}.pt",
                                     weights_only=False)
                          for r in range(WORLD)]
        out["step_fail"] = [
            (work / f"step_fail_rank{r}.txt").read_text()
            if (work / f"step_fail_rank{r}.txt").exists() else ""
            for r in range(WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _agreed(runs):
    """Every rank's strategy and timings are rank 0's."""
    for r in runs[1:]:
        assert r["strategy"] == runs[0]["strategy"]
        _same_timings(
            {k: v for k, v in r["timings"].items() if k != "bayes_tune"},
            {k: v for k, v in runs[0]["timings"].items()
             if k != "bayes_tune"})
    return runs[0]


def test_one_slower_rank_moves_every_rank_alike(ranks):
    run = _agreed(ranks["slow"])
    slowed = run["slowed"]
    assert run["timings"][slowed][0] >= 5.0
    assert run["strategy"].describe() != slowed
    # the analytic first was dropped on every rank in round one
    assert len(run["timings"][slowed]) == 1


def test_a_build_failure_on_one_rank_is_skipped_on_every_rank(ranks):
    run = _agreed(ranks["build_fail"])
    fsdp = [k for k in run["timings"] if "fsdp=" in k]
    assert fsdp, run["timings"]
    for k in fsdp:
        assert all(math.isnan(t) for t in run["timings"][k]), k
    assert run["strategy"].fsdp == 1
    assert any(not math.isnan(t) for v in run["timings"].values()
               for t in v)


def test_a_layout_the_model_cannot_run_is_skipped_on_every_rank(ranks):
    """Two kv heads on tensor 4: the model's ``check_mesh`` fails the
    candidate at its build, every rank records it as failed, and the
    race goes on to a winner the model runs."""
    run = _agreed(ranks["heads"])
    assert "tp=4" in run["timings"], run["timings"]
    assert all(math.isnan(t) for t in run["timings"]["tp=4"])
    assert run["strategy"].tensor in (1, 2)
    assert any(not math.isnan(t) for k, v in run["timings"].items()
               for t in v if k != "tp=4")


def test_a_rank_late_out_of_its_warm_up_is_not_timed(ranks):
    """The ranks meet before the window: rank 1 ending each warm-up 2 s
    late does not reach the others' timed collectives."""
    run = _agreed(ranks["late"])
    times = [t for v in run["timings"].values() for t in v if t == t]
    assert times and max(times) < 1.0, run["timings"]


def test_a_step_failure_raises_and_is_not_skipped(ranks):
    texts = ranks["step_fail"]
    assert "planted step failure" in texts[1], texts[1] or ranks["logs"][1]
    assert ranks["rc"][1] == 3
    # no rank took the failed step for a failed candidate and went on
    assert "returned" not in texts


def test_the_race_gives_its_process_groups_back(ranks):
    for phase in ("slow", "build_fail", "heads"):
        for r in ranks[phase]:
            before, after = r["groups"]
            assert after - before == r["mesh_groups"], (phase, r["groups"])


def test_the_call_without_a_dry_run_picks_jax_candidates_0_at_world_4(
        ranks):
    run = _agreed(ranks["plain"])
    jp, _ = _tiny_profiles()
    want = jstrategy.generate_candidates(jp, WORLD, global_batch=4,
                                         seq_len=16)[0]
    assert _d(run["strategy"]) == _d(want)
    assert run["timings"] == {}
