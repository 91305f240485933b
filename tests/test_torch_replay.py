"""The port's replay recorder, digests, loss-spike capture, numeric
checker and callbacks against the JAX package's, on the CPU.

- ``pytree_digest`` of a port train state equals the JAX digest of the
  JAX state it was converted from (AGD, bf16 params, int8 moments) and
  of a batch; the key path text is JAX's own for every kind of key.
- A recording the JAX ``ReplayRecorder`` wrote replays in the port
  (batch digests matching), and the port's recording in the JAX
  ``replay``.
- ``Trainer(replay_dir=...)`` records a window after a restored step;
  the port's ``replay`` re-runs it bit for bit from the restored state
  and catches the two planted faults (one token changed in a batch
  file, one element of the start state one ulp off).
- ``LossSpikeCapture`` flags the same steps and writes the same records
  (timestamp aside) as the JAX one on one seeded loss series;
  ``NumericChecker`` records and the callbacks' outputs equal JAX's,
  from the objects themselves; the ``Trainer`` fires the callbacks at
  the reference's points.
"""

import importlib
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.observability import metrics as jmetrics  # noqa: E402
from dlrover_tpu.parallel.train_step import make_train_state  # noqa: E402
from dlrover_tpu.trainer import callbacks as jcb  # noqa: E402
from dlrover_tpu.trainer import fault_tolerance as jft  # noqa: E402
from dlrover_tpu.trainer import replay as jreplay  # noqa: E402
from dlrover_tpu_torch.accelerate import auto_accelerate  # noqa: E402
from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    HostScalar,
    params_from_jax,
    train_state_leaves,
)
from dlrover_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from dlrover_tpu_torch.optimizers import (  # noqa: E402
    AGD,
    QuantizedMoments,
    quantized_state_from_jax,
)
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs  # noqa: E402
from dlrover_tpu_torch.trainer import callbacks as tcb  # noqa: E402
from dlrover_tpu_torch.trainer import fault_tolerance as tft  # noqa: E402
from dlrover_tpu_torch.trainer import replay as treplay  # noqa: E402

jagd = importlib.import_module("dlrover_tpu.optimizers.agd")
jlow = importlib.import_module("dlrover_tpu.optimizers.low_bit")
SEED = 0


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU's threaded reductions are not
    bit-reproducible from call to call, the card's kernels are."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp(tmp_path):
    return str(tmp_path)


# ------------------------------------------------------------- states


def _jax_params(dtype=jnp.float32):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat="none")
    params = jl.init_params(jax.random.PRNGKey(3), jcfg)
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


def _randomized(tree, seed):
    """Every leaf of ``tree`` replaced by seeded values of its dtype."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape, np.int8))
        if np.issubdtype(a.dtype, np.integer):
            return jnp.asarray(7, a.dtype) if a.ndim == 0 else jnp.asarray(
                rng.integers(0, 9, a.shape).astype(a.dtype))
        return jnp.asarray(rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(leaf, tree)


def _jax_state(opt, dtype=jnp.float32):
    jp = _jax_params(dtype)
    tx = jagd.agd(1e-3) if opt == "agd" else jlow.quantized_moments(1e-3)
    st = make_train_state(jp, tx)
    return _randomized(st, 11)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dict_leaves(node, path=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _dict_leaves(node[k], path + (k,))
    else:
        yield path, node


def _port_state(jstate, opt):
    """The port state the converters make from the JAX state's arrays."""
    bf16 = jstate["params"]["embed"].dtype == jnp.bfloat16
    # numpy has no bf16 of its own: bf16 values pass through fp32 exactly
    npp = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jstate["params"])
    params = params_from_jax(npp, "cpu", torch.bfloat16 if bf16 else None)
    leaves = [t for _, t in _dict_leaves(params)]
    s = jstate["opt_state"]
    if opt == "agd":
        o = AGD(leaves, lr=1e-3)
        o.init_state()
        for path, p in _dict_leaves(params):
            for name in ("exp_avg", "exp_avg_sq"):
                o.state[p][name] = torch.from_numpy(
                    np.array(_get(getattr(s, name), path)))
            o.state[p]["step"] = int(s.step)
    else:
        o = QuantizedMoments(leaves, lr=1e-3)
        quantized_state_from_jax(jax.tree_util.tree_map(np.asarray, s),
                                 params, o)
    return {"step": int(jstate["step"]), "params": params, "opt_state": o}


@pytest.mark.parametrize("opt,dtype", [
    ("agd", jnp.float32), ("agd", jnp.bfloat16), ("int8", jnp.float32)])
def test_digest_of_a_converted_state_equals_the_jax_digest(opt, dtype):
    jstate = _jax_state(opt, dtype)
    pstate = _port_state(jstate, opt)
    assert tft.pytree_digest(pstate) == jft.pytree_digest(jstate)
    # the key paths are JAX's, in its order; one byte anywhere shows
    want = [(str(p), jax.tree_util.keystr(p))
            for p, _ in jax.tree_util.tree_leaves_with_path(jstate)]
    got = [(tft.jax_path_str(k), k) for k, _ in train_state_leaves(pstate)]
    assert got == want
    with torch.no_grad():
        w = pstate["params"]["layers"]["wq"]
        w.view(-1).view(torch.uint8)[-1] ^= 1
    assert tft.pytree_digest(pstate) != jft.pytree_digest(jstate)


def test_digest_of_batches_and_nested_trees_equals_jax():
    rng = np.random.default_rng(SEED)
    tree = {"tokens": rng.integers(0, 99, (2, 5)).astype(np.int32),
            "extra": [rng.standard_normal(3).astype(np.float32),
                      {"mask": rng.integers(0, 2, (4,)).astype(np.int8)}]}
    port = {"tokens": torch.from_numpy(tree["tokens"]),
            "extra": [torch.from_numpy(tree["extra"][0]),
                      {"mask": torch.from_numpy(tree["extra"][1]["mask"])}]}
    assert tft.pytree_digest(port) == jft.pytree_digest(tree)
    assert tft.pytree_digest(tree) == jft.pytree_digest(tree)
    with pytest.raises(ValueError, match="not a key path"):
        tft.jax_path_str("['a']?")


# -------------------------------------------------- recordings, both ways


def _batches(n, vocab=256, seed=SEED):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (2, 13)).astype(np.int32)}
            for _ in range(n)]


def _tiny_result():
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, remat="none")
    npp = jax.tree_util.tree_map(np.asarray, _jax_params())
    return auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, tcfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=lambda gen, dev: params_from_jax(npp, "cpu",
                                                        torch.float32),
        device="cpu")


def test_a_jax_recording_replays_in_the_port(tmp):
    batches = _batches(3)
    rec = jreplay.ReplayRecorder(tmp)
    for step, b in enumerate(batches, 1):
        rec.record(step, b)
    result = _tiny_result()
    state = result.fns.init_state(0)
    rep = treplay.replay(tmp, result.fns.train_step, state, 1, 3)
    assert rep.replayed_steps == [1, 2, 3] and rep.complete
    assert rep.diverged_at is None and state["step"] == 3
    # the port's batch digests are the JAX recorder's
    journal = treplay._load_journal(tmp)
    assert [treplay.pytree_digest(b) for b in batches] == [
        journal[s]["batch_digest"] for s in (1, 2, 3)]


def test_a_port_recording_replays_in_jax(tmp):
    batches = _batches(2)
    rec = treplay.ReplayRecorder(tmp, keep_steps=5)
    for step, b in enumerate(batches, 1):
        rec.record(step, {"tokens": torch.from_numpy(b["tokens"])})
    seen = []

    def jax_step(state, batch):
        seen.append(batch["tokens"])
        return state + 1, {}

    rep = jreplay.replay(tmp, jax_step, 0, 1, 2)
    assert rep.replayed_steps == [1, 2] and rep.complete
    assert all(np.array_equal(a, b["tokens"]) for a, b in zip(seen, batches))
    assert treplay._load_journal(tmp) == jreplay._load_journal(tmp)


class _Agent:
    """The saver an agent would host, in this process."""

    def __init__(self):
        self.factory = AsyncCheckpointSaver.start_async_saving_ckpt(
            install_signal_handlers=False)

    def close(self):
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        if saver is not None:
            saver.close(unlink=True)
        AsyncCheckpointSaver._instance = None
        self.factory.close()


@pytest.fixture
def agent(monkeypatch):
    d = tempfile.mkdtemp(prefix="dtr", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d)
    a = _Agent()
    yield a
    a.close()
    shutil.rmtree(d, ignore_errors=True)


def test_trainer_records_and_the_port_replays_bit_for_bit(tmp, agent):
    result = _tiny_result()
    batches = _batches(5)
    ckpt, rdir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "replay")

    def trainer(max_steps, **kw):
        t = Trainer(result, TrainingArgs(
            max_steps=max_steps, log_interval=0, checkpoint_dir=ckpt,
            save_memory_interval=2, save_storage_interval=100, **kw),
            lambda: iter(batches[t.state["step"]:]))
        return t

    trainer(2).train()
    t2 = trainer(5, replay_dir=rdir, replay_digest_interval=1)
    assert t2.restore() == 2
    leaves = train_state_leaves(t2.state)
    saved = [v.detach().clone() if torch.is_tensor(v) else v.get()
             for _, v in leaves]

    def reset():
        with torch.no_grad():
            for (_, v), w in zip(leaves, saved):
                v.set(w) if isinstance(v, HostScalar) else v.copy_(w)

    t2.train()
    root = os.path.join(rdir, "rank00000")
    journal = treplay._load_journal(root)
    assert sorted(journal) == [3, 4, 5]
    assert all("state_digest" in journal[s] for s in (3, 4, 5))
    # the journal's last digest is the trained state's
    assert journal[5]["state_digest"] == tft.pytree_digest(t2.state)
    step = result.fns.train_step

    reset()
    rep = treplay.replay(root, step, t2.state, 3, 5)
    assert rep.replayed_steps == [3, 4, 5] and rep.deterministic
    assert rep.complete

    path = treplay._batch_path(root, 4)
    with np.load(path) as data:
        batch = {k: data[k].copy() for k in data.files}
    batch["tokens"][0, 0] = (batch["tokens"][0, 0] + 1) % 256
    np.savez(path, **batch)
    reset()
    bad = treplay.replay(root, step, t2.state, 3, 5)
    assert bad.corrupt_batches == [4] and bad.replayed_steps == [3]
    assert bad.diverged_at is None and not bad.complete

    reset()
    with torch.no_grad():
        w = t2.state["params"]["layers"]["wq"].view(-1)[:1]
        w.copy_(torch.nextafter(w, torch.full_like(w, 1e30)))
    nudged = treplay.replay(root, step, t2.state, 3, 3)
    assert nudged.diverged_at == 3 and nudged.replayed_steps == [3]


def test_a_missing_batch_truncates_the_window(tmp):
    rec = treplay.ReplayRecorder(tmp, keep_steps=2)
    for step, b in enumerate(_batches(4), 1):
        rec.record(step, b)
    # the ring kept the newest two batch files
    assert sorted(os.listdir(tmp)) == [
        "batch-0000000003.npz", "batch-0000000004.npz", "journal.jsonl"]
    rep = treplay.replay(tmp, lambda s, b: (s, {}), {}, 1, 4)
    assert rep.missing_batches == [1] and rep.replayed_steps == []


# ----------------------------------------------- spikes, checker, callbacks


def _loss_series():
    rng = np.random.default_rng(SEED)
    losses = 3.0 + 0.05 * rng.standard_normal(60)
    losses[[25, 41, 42]] += (2.0, 1.5, 3.0)
    return [float(x) for x in losses]


def _spike_records(d):
    with open(os.path.join(d, "spikes.jsonl")) as f:
        out = [json.loads(line) for line in f]
    for r in out:
        assert r.pop("timestamp") > 0
    return out


def test_loss_spike_capture_equals_jax(tmp):
    got, want = {}, {}
    for name, mod, out in (("jax", jft, want), ("torch", tft, got)):
        d = os.path.join(tmp, name)
        cap = mod.LossSpikeCapture(d)
        flags = []
        for step, loss in enumerate(_loss_series(), 1):
            tokens = np.random.default_rng(step).integers(
                0, 99, (2, 5)).astype(np.int32)
            batch = {"tokens": tokens, "mask": np.ones(5, np.float32)}
            if name == "torch":
                batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            flags.append(cap.observe(step, loss, batch))
        out["flags"] = [s for s, f in enumerate(flags, 1) if f]
        out["records"] = _spike_records(d)
        out["npz"] = {f: dict(np.load(os.path.join(d, f)))
                      for f in sorted(os.listdir(d)) if f.endswith(".npz")}
    assert got["flags"] == want["flags"] and want["flags"]
    assert got["records"] == want["records"]
    assert got["npz"].keys() == want["npz"].keys()
    for f in want["npz"]:
        for k in want["npz"][f]:
            assert np.array_equal(got["npz"][f][k], want["npz"][f][k])


@pytest.mark.parametrize("case", ["equal", "nudged", "shape", "structure"])
def test_numeric_checker_records_equal_jax(case):
    a = _jax_state("agd")
    b = _randomized(a, 11)  # the same values
    if case == "nudged":
        b = jax.tree_util.tree_map(lambda x: x, b)
        wq = np.array(b["params"]["layers"]["wq"])
        wq.reshape(-1)[3] *= 1.0 + 3e-5
        b["params"]["layers"]["wq"] = jnp.asarray(wq)
    pa, pb = _port_state(a, "agd"), _port_state(b, "agd")
    if case == "shape":
        b = {"x": jnp.zeros((2, 3))}
        a = {"x": jnp.zeros((3, 2))}
        pa = {"x": torch.zeros(3, 2)}
        pb = {"x": torch.zeros(2, 3)}
    if case == "structure":
        b = {"x": jnp.zeros(2), "y": jnp.zeros(2)}
        a = {"x": jnp.zeros(2)}
        pa = {"x": torch.zeros(2)}
        pb = {"x": torch.zeros(2), "y": torch.zeros(2)}
    jc, tc = jft.NumericChecker(), tft.NumericChecker()
    assert jc.compare_trees("s", a, b) == tc.compare_trees("s", pa, pb)
    assert tc.records == jc.records
    if case == "nudged":
        assert not tc.records[0]["match"]
        assert tc.records[0]["max_rel_err"] > 0


def _drive_callbacks(cbs):
    cbs.on_train_begin(0)
    for step in range(1, 5):
        cbs.on_step_end(step, {"loss": 3.0 / step, "step_time_s": 0.5,
                               "grad_norm": 1.0 + step})
        if step % 2 == 0:
            cbs.on_save(step, storage=step == 4)
    cbs.on_eval(4, {"eval_loss": 2.5, "eval_batches": 2,
                    "eval_time_s": 0.1})
    cbs.on_train_end({"final_step": 4, "mean_step_time": 0.5})


def _log_records(d):
    with open(os.path.join(d, "train_log.jsonl")) as f:
        out = [json.loads(line) for line in f]
    for r in out:
        assert r.pop("t") > 0
    return out


def test_callbacks_equal_jax(tmp):
    class Broken(jcb.TrainerCallback):
        def on_step_end(self, step, metrics):
            raise RuntimeError("boom")

    class TBroken(tcb.TrainerCallback):
        def on_step_end(self, step, metrics):
            raise RuntimeError("boom")

    jreg = jmetrics.MetricsRegistry(path=os.path.join(tmp, "j.prom"))
    treg = tmetrics.MetricsRegistry()
    _drive_callbacks(jcb.CallbackList([
        Broken(), jcb.MetricsCallback(jreg),
        jcb.JsonlLoggerCallback(os.path.join(tmp, "j"), train_every=2)]))
    _drive_callbacks(tcb.CallbackList([
        TBroken(), tcb.MetricsCallback(treg),
        tcb.JsonlLoggerCallback(os.path.join(tmp, "t"), train_every=2)]))
    assert treg._metrics == jreg._metrics and treg._metrics
    assert _log_records(os.path.join(tmp, "t")) == _log_records(
        os.path.join(tmp, "j"))


def test_tensorboard_callback_writes_or_raises(tmp, monkeypatch):
    pytest.importorskip("tensorboard")
    _drive_callbacks(tcb.CallbackList([tcb.TensorBoardCallback(
        os.path.join(tmp, "tb"))]))
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(os.path.join(tmp, "tb")))
    import builtins

    real = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError):
        tcb.TensorBoardCallback(os.path.join(tmp, "tb2"))


class _Seen(tcb.TrainerCallback):
    def __init__(self):
        self.calls = []

    def on_train_begin(self, start_step):
        self.calls.append(("begin", start_step))

    def on_step_end(self, step, metrics):
        self.calls.append(("step", step, sorted(metrics)))

    def on_save(self, step, storage):
        self.calls.append(("save", step, storage))

    def on_eval(self, step, metrics):
        self.calls.append(("eval", step, sorted(metrics)))

    def on_train_end(self, summary):
        self.calls.append(("end", summary["final_step"]))


def test_trainer_fires_callbacks_and_captures_spikes(tmp, agent):
    result = _tiny_result()
    batches = _batches(4)
    seen = _Seen()
    t = Trainer(result, TrainingArgs(
        max_steps=4, log_interval=0, eval_interval=4,
        checkpoint_dir=os.path.join(tmp, "ckpt"), save_memory_interval=2,
        save_storage_interval=4, capture_loss_spikes=True),
        lambda: iter(batches), eval_iter_fn=lambda: iter(batches[:1]),
        callbacks=[seen])
    t.train()
    keys = ["grad_norm", "loss", "step_time_s"]
    assert seen.calls == [
        ("begin", 0), ("step", 1, keys), ("save", 2, False),
        ("step", 2, keys), ("step", 3, keys), ("save", 4, True),
        ("step", 4, keys), ("eval", 4, ["eval_batches", "eval_loss",
                                        "eval_time_s"]), ("end", 4)]
    # the capture sat beside the checkpoints (20 steps of history first)
    assert os.path.isdir(os.path.join(tmp, "ckpt", "spikes"))
    assert [h["step"] for h in t.history] == [1, 2, 3, 4]


def test_replay_dir_builds_the_recorder(tmp):
    """``replay_dir`` raised until replay was ported; it now builds the
    recorder under ``rank<r>``, and a batches-only interval records no
    digest."""
    result = _tiny_result()
    batches = _batches(2)
    t = Trainer(result, TrainingArgs(
        max_steps=2, log_interval=0, replay_dir=tmp,
        replay_digest_interval=0), lambda: iter(batches))
    t.train()
    journal = treplay._load_journal(os.path.join(tmp, "rank00000"))
    assert sorted(journal) == [1, 2]
    assert not any("state_digest" in e for e in journal.values())
