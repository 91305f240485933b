"""The port's flash checkpoint against the JAX package's, on the CPU.

- The shm handler: round trip (bf16 too), growth, invalid meta, the
  dual slot, the generation side-segment (the cases of
  ``tests/test_flash_checkpoint.py:53-235``, on tensors).
- The engine: memory and disk save, the two-phase commit, load, the
  restore-step consensus (and its refusal without a process group).
- ``Trainer`` stopped after step 2 and restarted, from shm and from disk,
  ends step 4 with losses, grad norms and every state leaf equal bit for
  bit to an uninterrupted run: ``LlamaConfig.tiny()`` with AGD and with
  ``QuantizedMoments``, fp32 and bf16 compute.  A flipped byte in the
  restored slot is seen by the leaf comparison.
- Cross-package shards: a ``.drckpt`` written by the JAX
  ``CheckpointEngine`` from a JAX train state restores into the port's
  state bit for bit (the state as ``params_from_jax`` and the optimizer
  converters make it from the same arrays), and the reverse.
- DCP export and import round-trip bit for bit.

Every comparison here is exact (``torch.equal`` on the bytes' values).
"""

import functools
import importlib
import os
import shutil
import tempfile
import uuid

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.agent import ckpt_shm as jshm  # noqa: E402
from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel.train_step import make_train_state  # noqa: E402
from dlrover_tpu.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine as JaxEngine,
)
from dlrover_tpu_torch.accelerate import auto_accelerate  # noqa: E402
from dlrover_tpu_torch.agent.ckpt_saver import (  # noqa: E402
    AsyncCheckpointSaver,
    find_latest_checkpoint,
)
from dlrover_tpu_torch.agent.ckpt_shm import (  # noqa: E402
    SHM_PREFIX,
    SharedMemoryHandler,
    _flatten_keyed,
    read_shard_file,
    restore_to_target,
)
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    CheckpointConstant,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    train_state_leaves,
)
from dlrover_tpu_torch.optimizers import AGD, QuantizedMoments  # noqa: E402
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs  # noqa: E402
from dlrover_tpu_torch.trainer.checkpoint import (  # noqa: E402
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.checkpoint.dcp_interop import (  # noqa: E402
    export_dcp,
    import_dcp,
)
from dlrover_tpu_torch.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
    _newest_common_step,
)

# the packages re-export functions of their modules' names
jagd = importlib.import_module("dlrover_tpu.optimizers.agd")
jlow = importlib.import_module("dlrover_tpu.optimizers.low_bit")


@pytest.fixture(autouse=True)
def _port_sockets(monkeypatch):
    """A short socket dir of the port's own for each test (AF_UNIX paths
    are limited to 107 bytes)."""
    d = tempfile.mkdtemp(prefix="dtt", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d)
    yield
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def ckpt_dir():
    d = tempfile.mkdtemp(prefix="dtc", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def uniq(tag: str) -> str:
    """A segment name of this test's own: shm segments and their
    sockets are machine-wide, and two runs of one test side by side
    must not attach to each other's."""
    return f"{tag}{uuid.uuid4().hex[:8]}"


def make_state(step=0, scale=1.0):
    return {
        "params": {
            "w": torch.ones(4, 8) * scale,
            "b": torch.arange(8).to(torch.bfloat16) * scale,
        },
        "opt": {"mu": torch.full((4, 8), 0.5)},
        "step": torch.tensor(step, dtype=torch.int64),
    }


def zeros_like_state(state):
    if isinstance(state, dict):
        return {k: zeros_like_state(v) for k, v in state.items()}
    return torch.zeros_like(state)


def assert_equal(a, b):
    fa, fb = _flatten_keyed(a), _flatten_keyed(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


# ----------------------------------------------------------- shm handler


def test_shm_round_trip_keeps_bf16():
    handler = SharedMemoryHandler(0, name=uniq("t1"), host=True)
    try:
        state = make_state(step=3)
        assert handler.save_state(3, state) == 4 * 8 * 4 + 8 * 2 + 32 * 4 + 8
        step, arrays = handler.load_state()
        assert step == 3
        restored = restore_to_target(zeros_like_state(state), arrays)
        assert restored["params"]["b"].dtype == torch.bfloat16
        assert_equal(state, restored)
        del arrays
    finally:
        handler.close(unlink=True)


def test_shm_growth_and_invalid_meta():
    handler = SharedMemoryHandler(0, name=uniq("t2"), host=True)
    try:
        assert handler.get_step() == -1
        handler.save_state(1, {"a": torch.zeros(4)})
        # past the 4 KiB-aligned stride: the segment is recreated
        handler.save_state(2, {"a": torch.zeros(4), "b": torch.ones(2000)})
        step, arrays = handler.load_state()
        assert step == 2 and arrays["['b']"].shape == (2000,)
        assert handler.steps_available() == [2]  # growth dropped step 1
        del arrays
        handler.mark_invalid()
        assert handler.get_step() == -1 and handler.steps_available() == []
        assert handler.load_state() == (-1, {})
    finally:
        handler.close(unlink=True)


def test_dual_slot_keeps_previous_snapshot():
    handler = SharedMemoryHandler(0, name=uniq("slots"), host=True)
    try:
        for s in (5, 6):
            handler.save_state(s, {"w": torch.full((4,), float(s))})
        assert handler.steps_available() == [6, 5]
        for want, got_step in ((5, 5), (None, 6)):
            step, arrays = handler.load_state(step=want)
            assert step == got_step
            assert float(arrays["['w']"][0]) == float(got_step)
        handler.save_state(7, {"w": torch.full((4,), 7.0)})
        assert handler.steps_available() == [7, 6]
        meta = handler.meta.get_all()
        assert meta["valid"] and meta["step"] == 7
    finally:
        handler.close(unlink=True)


def test_generation_segment_and_the_port_namespace():
    handler = SharedMemoryHandler(0, name=uniq("gen"), host=True)
    try:
        assert handler.peek_generation() == -1
        handler.publish_generation(11)
        assert handler.peek_generation() == 11
        assert handler._shm_name.startswith(SHM_PREFIX + "_")
        assert SHM_PREFIX != jshm.SHM_PREFIX
    finally:
        handler.close(unlink=True)


# ----------------------------------------------------------- the engine


def test_memory_save_and_load(ckpt_dir):
    ckpt = Checkpointer(ckpt_dir, process_rank=0, process_count=1,
                        node_rank=0, name=uniq("m1"))
    try:
        state = make_state(step=10)
        assert ckpt.save_checkpoint(10, state, StorageType.MEMORY)
        step, restored = ckpt.load_checkpoint(
            target=zeros_like_state(state))
        assert step == 10
        assert_equal(state, restored)
    finally:
        ckpt.close()


def test_disk_save_commit_and_load(ckpt_dir):
    ckpt = Checkpointer(ckpt_dir, process_rank=0, process_count=1,
                        node_rank=0, name=uniq("d1"))
    try:
        state = make_state(step=20, scale=2.0)
        assert ckpt.save_checkpoint(20, state, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(20, timeout=30)
        final = os.path.join(ckpt_dir, "checkpoint-20")
        assert os.path.exists(os.path.join(final, "shard_0.drckpt"))
        assert not os.path.exists(os.path.join(
            ckpt_dir, CheckpointConstant.STAGE_DIR, "checkpoint-20"))
        step, arrays = read_shard_file(os.path.join(final, "shard_0.drckpt"))
        assert step == 20
        assert_equal(state, restore_to_target(zeros_like_state(state),
                                              arrays))
        for s in (21, 22):
            ckpt.save_checkpoint(s, make_state(s), StorageType.DISK)
            assert ckpt.wait_latest_checkpoint(s, timeout=30)
        assert ckpt.latest_persisted_step() == 22
        assert find_latest_checkpoint(ckpt_dir).endswith("checkpoint-22")
    finally:
        ckpt.close()


def test_load_prefers_newer_shm_and_the_consensus(ckpt_dir):
    ckpt = Checkpointer(ckpt_dir, process_rank=0, process_count=1,
                        node_rank=0, name=uniq("d2"))
    try:
        old, new = make_state(1, 1.0), make_state(2, 9.0)
        ckpt.save_checkpoint(1, old, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(1, timeout=30)
        ckpt.save_checkpoint(2, new, StorageType.MEMORY)
        step, restored = ckpt.load_checkpoint(target=zeros_like_state(new))
        assert step == 2 and float(restored["params"]["w"][0, 0]) == 9.0
        # a relaunched peer holds only the committed step 1
        ckpt._engine._step_sync_fn = (
            lambda avail: _newest_common_step([avail, [1, 1, 1]]))
        step, restored = ckpt.load_checkpoint(target=zeros_like_state(new))
        assert step == 1 and float(restored["params"]["w"][0, 0]) == 1.0
    finally:
        ckpt.close()


@pytest.mark.parametrize("rows,want", [
    ([[13, -1], [12, -1]], -1), ([[13, 10], [12, 10]], 10),
    ([[13, 10], [13, 10]], 13), ([[-1, -1], [-1, -1]], -1),
])
def test_newest_common_step_matches_jax(rows, want):
    from dlrover_tpu.trainer.checkpoint.engine import (
        _newest_common_step as jax_newest,
    )

    assert _newest_common_step(rows) == jax_newest(rows) == want


def test_consensus_needs_a_group_beyond_one_process(ckpt_dir):
    name = uniq("c2")
    engines = [CheckpointEngine(ckpt_dir, process_rank=r, process_count=2,
                                local_shard_num=2, name=name)
               for r in range(2)]
    try:
        with pytest.raises(RuntimeError, match="process group"):
            engines[1].load()
        engines[1]._step_sync_fn = max
        assert engines[1].load() == (-1, None)
    finally:
        engines[1].close()
        engines[0].close()


_GLOO_RANK = """
import sys, types
import torch.distributed as dist
from dlrover_tpu_torch.trainer.checkpoint.engine import CheckpointEngine
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
rows = [([5, 3], -1), ([4, 3], 2)]
fake = types.SimpleNamespace(_step_sync_fn=None, _world=2, _rank=rank)
print(CheckpointEngine._sync_restore_step(fake, *rows[rank]))
dist.destroy_process_group()
"""


def test_consensus_over_a_gloo_group():
    """Two processes, torn shm (rank 0 holds 5 and 3, rank 1 holds 4 and
    3 plus a committed 2): both agree on 3, the newest step on both."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, str(r), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo)) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip().splitlines()[-1] for o, _ in outs] == ["3", "3"]


def test_async_save_and_preallocate(ckpt_dir):
    ckpt = Checkpointer(ckpt_dir, process_rank=0, process_count=1,
                        node_rank=0, name=uniq("d6"))
    try:
        state = make_state(step=30, scale=3.0)
        engine = ckpt._engine
        assert engine.preallocate_like(state) > 0
        assert engine.save_to_memory(30, state, blocking=False)
        assert engine.wait_for_snapshot(timeout=30)
        step, restored = ckpt.load_checkpoint(
            target=zeros_like_state(state))
        assert step == 30
        assert_equal(state, restored)
        state2 = make_state(step=31, scale=4.0)
        assert engine.save_to_storage(31, state2, blocking=False)
        assert engine.wait_for_snapshot(timeout=30)
        assert ckpt.wait_latest_checkpoint(31, timeout=30)
    finally:
        ckpt.close()


# ------------------------------------------------ Trainer, bit for bit


@functools.lru_cache(maxsize=None)
def _jax_params_cached(seed):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat="none")
    return jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(seed), jcfg))


def _jax_params(seed=3):
    return _jax_params_cached(seed)


def _result(npp, compute, opt, agd=AGD):
    tcfg = tl.LlamaConfig.tiny(dtype=compute, remat="none")

    def optimizer(ps):
        if opt == "agd":
            return agd(ps, lr=1e-3)
        return QuantizedMoments(ps, lr=1e-3, weight_decay=0.1)

    return auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, tcfg),
        optimizer=optimizer,
        init_params_fn=lambda gen, dev: params_from_jax(
            npp, "cpu", torch.float32),
        device="cpu",
    )


def _state_copy(state):
    return {k: torch.as_tensor(v).detach().clone()
            for k, v in _flatten_keyed(state)}


class _Agent:
    """The saver an agent would host, in this process: snapshots in shm
    outlive each ``Trainer``."""

    def __init__(self):
        self.factory = AsyncCheckpointSaver.start_async_saving_ckpt(
            install_signal_handlers=False)

    def drop_shm(self):
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        if saver is not None:
            saver.close(unlink=True)
        AsyncCheckpointSaver._instance = None

    def close(self):
        self.drop_shm()
        self.factory.close()


@pytest.fixture
def agent():
    a = _Agent()
    yield a
    a.close()


def _train(result, batches, max_steps, **ckpt):
    trainer = Trainer(result, TrainingArgs(max_steps=max_steps,
                                           log_interval=0, **ckpt),
                      lambda: iter(batches[trainer.state["step"]:]))
    trainer.train()
    return trainer


def _history(trainer):
    return [(r["step"], r["loss"], r["grad_norm"]) for r in trainer.history]


@pytest.mark.parametrize("opt", ["agd", "int8"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_trainer_resumes_bit_for_bit(opt, compute, agent, ckpt_dir):
    npp = _jax_params()
    result = _result(npp, getattr(torch, compute), opt)
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, 256, (2, 13)).astype(np.int32)}
               for _ in range(4)]
    run_a = _train(result, batches, 4)
    want = _state_copy(run_a.state)
    mode = "copy" if opt == "agd" else "staged"
    ck = dict(checkpoint_dir=ckpt_dir, save_memory_interval=1,
              save_storage_interval=2, snapshot_mode=mode)
    run_b = _train(result, batches, 2, **ck)
    assert _history(run_b) == _history(run_a)[:2]  # determinism
    assert [(s["step"], s["mode"]) for s in run_b.save_times] == [
        (1, mode), (2, mode)]
    disk_dir = ckpt_dir + "_disk"
    os.rename(ckpt_dir, disk_dir)  # C must restore from shm alone
    try:
        # a flipped byte in the restored slot: the leaf comparison sees it
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        meta = saver._shm_handlers[0].meta.get_all()
        key, _, _, off, nb = meta["specs"][-3]
        pos = meta["base"] + off + nb - 1
        buf = saver._shm_handlers[0]._shm.buf
        buf[pos] ^= 0xFF
        engine = CheckpointEngine(ckpt_dir)
        state = result.fns.init_state(0)
        assert engine.load(target=state)[0] == 2
        engine.close()
        buf[pos] ^= 0xFF
        for batch in batches[2:]:
            result.fns.train_step(state, {"tokens": torch.from_numpy(
                batch["tokens"])})
        got = _state_copy(state)
        assert any(not torch.equal(got[k], want[k]) for k in want)

        run_c = _train(result, batches, 4, **ck)  # from shm
        assert _history(run_c) == _history(run_a)[2:]
        assert_equal(want, _state_copy(run_c.state))
        agent.drop_shm()
        run_d = _train(result, batches, 4,
                       **dict(ck, checkpoint_dir=disk_dir))  # from disk
        assert _history(run_d) == _history(run_a)[2:]
        assert_equal(want, _state_copy(run_d.state))
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)


def test_a_skipped_optimizer_step_changes_the_losses(agent, ckpt_dir):
    """The planted fault of the chip check: the loss comparison rejects a
    restore that leaves the optimizer's step count at 0."""
    npp = _jax_params()
    result = _result(npp, torch.float32, "agd")
    rng = np.random.default_rng(6)
    batches = [{"tokens": rng.integers(0, 256, (2, 13)).astype(np.int32)}
               for _ in range(4)]
    want = _history(_train(result, batches, 4))[2:]
    _train(result, batches, 2, checkpoint_dir=ckpt_dir,
           save_memory_interval=1, save_storage_interval=2)
    engine = CheckpointEngine(ckpt_dir)
    state = result.fns.init_state(0)
    assert engine.load(target=state)[0] == 2
    engine.close()
    dict(train_state_leaves(state))["['opt_state'].step"].set(0)
    got = []
    for batch in batches[2:]:
        _, m = result.fns.train_step(
            state, {"tokens": torch.from_numpy(batch["tokens"])})
        got.append((state["step"], float(m["loss"]),
                    float(m["grad_norm"])))
    assert got[0] == want[0] and got[1] != want[1]


class _FailingAGD(AGD):
    """AGD whose fourth step writes one parameter and then raises: an
    update cut part-way, as an out-of-memory error would cut it."""

    def __init__(self, params, **kw):
        super().__init__(params, **kw)
        self.calls = 0

    def step(self, closure=None):
        self.calls += 1
        if self.calls == 4:
            with torch.no_grad():
                self.param_groups[0]["params"][0].add_(1.0)
            raise RuntimeError("optimizer failed part-way")
        return super().step(closure)


@pytest.mark.parametrize("where,persisted", [("optimizer", 2), ("data", 3)])
def test_a_failed_step_commits_no_torn_state(where, persisted, agent,
                                             ckpt_dir):
    """An exception inside ``train_step`` (``opt.step`` of step 4, after
    it wrote a parameter) propagates, and neither shm nor disk gets that
    state under step 3's number: shm keeps step 3's snapshot, disk step
    2.  One outside ``train_step`` (the data iterator, after step 3)
    propagates too, and step 3 is persisted.  Either way a restart
    resumes from step 3 bit for bit as an uninterrupted run.  "staged"
    snapshots, so that no save is skipped for a drain still running."""
    npp = _jax_params()
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, 256, (2, 13)).astype(np.int32)}
               for _ in range(4)]
    result = _result(npp, torch.float32, "agd")
    run_a = _train(result, batches, 4)
    want = _state_copy(run_a.state)
    ck = dict(checkpoint_dir=ckpt_dir, save_memory_interval=1,
              save_storage_interval=2, snapshot_mode="staged")

    def data():
        yield from batches[:3]
        if where == "data":
            raise RuntimeError("data failed")
        yield batches[3]

    failing = (_result(npp, torch.float32, "agd", agd=_FailingAGD)
               if where == "optimizer" else result)
    trainer = Trainer(failing, TrainingArgs(max_steps=4, log_interval=0,
                                            **ck), data)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        trainer.train()
    engine = CheckpointEngine(ckpt_dir)
    try:
        assert engine.wait_for_persist(persisted, timeout=30)
        assert engine.latest_persisted_step() == persisted
        assert engine._shm_handler.steps_available()[0] == 3
    finally:
        engine.close()
    run_c = _train(result, batches, 4, **ck)
    assert _history(run_c) == _history(run_a)[3:]
    assert_equal(want, _state_copy(run_c.state))


def test_an_optimizer_without_jax_key_paths_is_refused():
    params = {"w": torch.zeros(3)}
    state = {"step": 0, "params": params,
             "opt_state": torch.optim.SGD([params["w"]], lr=0.1)}
    with pytest.raises(NotImplementedError, match="SGD"):
        train_state_leaves(state)


# ------------------------------------------------- across the packages


@functools.lru_cache(maxsize=None)
def _jax_state_cached(opt):
    npp = _jax_params()
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tx = jagd.agd(1e-3) if opt == "agd" else jlow.quantized_moments(1e-3)
    st = make_train_state(jp, tx)
    # give every leaf a distinct value: one AGD/int8 update on random grads
    rng = np.random.default_rng(11)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jp)
    _, opt_state = jax.jit(tx.update)(grads, st["opt_state"], jp)
    return {"step": jnp.asarray(7, jnp.int32), "params": jp,
            "opt_state": opt_state}


def _jax_state(npp, opt):
    """A JAX train state after one update (every leaf distinct), made
    once per optimizer: the int8 update runs Pallas in interpret mode."""
    return _jax_state_cached(opt)


def _port_state_from_jax(jstate, opt):
    """The port's state made from the JAX arrays by the converters."""
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jstate["params"]),
                             "cpu", torch.float32)
    leaves = [t for _, t in sorted(_dict_leaves(params))]
    if opt == "agd":
        o = AGD(leaves, lr=1e-3)
        o.init_state()
        s = jstate["opt_state"]
        for (path, p) in sorted(_dict_leaves(params)):
            for name in ("exp_avg", "exp_avg_sq"):
                o.state[p][name] = torch.from_numpy(np.array(
                    _get(getattr(s, name), path)))
            o.state[p]["step"] = int(s.step)
    else:
        from dlrover_tpu_torch.optimizers import quantized_state_from_jax

        o = QuantizedMoments(leaves, lr=1e-3)
        quantized_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate["opt_state"]),
            params, o)
    return {"step": int(jstate["step"]), "params": params, "opt_state": o}


def _dict_leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _dict_leaves(v, path + (k,))
    else:
        yield path, node


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _fresh_port_state(npp, opt):
    params = params_from_jax(npp, "cpu", torch.float32)
    for t in (t for _, t in _dict_leaves(params)):
        t.zero_()
    leaves = [t for _, t in _dict_leaves(params)]
    o = AGD(leaves, lr=1e-3) if opt == "agd" else QuantizedMoments(
        leaves, lr=1e-3)
    o.init_state()
    return {"step": 0, "params": params, "opt_state": o}


@pytest.fixture
def jax_sockets(monkeypatch):
    """A short socket dir for the JAX package's engine."""
    d = tempfile.mkdtemp(prefix="djs", dir="/tmp")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", d)
    yield
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("opt", ["agd", "int8"])
def test_jax_shard_restores_in_the_port(opt, ckpt_dir, jax_sockets):
    npp = _jax_params()
    jstate = _jax_state(npp, opt)
    jeng = JaxEngine(ckpt_dir, name=uniq("x1"))
    try:
        assert jeng.save_to_storage(7, jstate)
        assert jeng.wait_for_persist(7, timeout=30)
    finally:
        jeng.close()
    target = _fresh_port_state(npp, opt)
    engine = CheckpointEngine(ckpt_dir, name=uniq("x2"))
    try:
        step, got = engine.load(target=target)
    finally:
        engine.close()
    assert step == 7 and got is target and got["step"] == 7
    assert_equal(_port_state_from_jax(jstate, opt), got)


@pytest.mark.parametrize("opt", ["agd", "int8"])
def test_port_shard_restores_in_jax(opt, ckpt_dir, jax_sockets):
    npp = _jax_params()
    jstate = _jax_state(npp, opt)
    engine = CheckpointEngine(ckpt_dir, name=uniq("y1"))
    try:
        assert engine.save_to_storage(7, _port_state_from_jax(jstate, opt))
        assert engine.wait_for_persist(7, timeout=30)
    finally:
        engine.close()
    # the port's shard holds the JAX package's header and raw bytes
    jeng = JaxEngine(ckpt_dir + "_jax", name=uniq("y2"))
    try:
        assert jeng.save_to_storage(7, jstate)
        assert jeng.wait_for_persist(7, timeout=30)
        target = jax.tree_util.tree_map(jnp.zeros_like, jstate)
        jeng2 = JaxEngine(ckpt_dir, name=uniq("y3"))
        step, got = jeng2.load(target=target)
        jeng2.close()
    finally:
        jeng.close()
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    shard = "checkpoint-7/shard_0.drckpt"
    ours = _read_shard_parts(os.path.join(ckpt_dir, shard))
    theirs = _read_shard_parts(os.path.join(ckpt_dir + "_jax", shard))
    shutil.rmtree(ckpt_dir + "_jax", ignore_errors=True)
    assert ours == theirs


def _read_shard_parts(path):
    """(unpickled header, raw bytes) of a ``.drckpt`` (pickle's memo makes
    the header's bytes depend on string identity, not its contents)."""
    import pickle
    import struct

    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack("<Q", blob[:8])
    return pickle.loads(blob[8:8 + n]), blob[8 + n:]


# ------------------------------------------------------------------ DCP


@pytest.mark.parametrize("opt", ["agd", "int8"])
def test_dcp_export_and_import_round_trip(opt, ckpt_dir, tmp_path):
    npp = _jax_params()
    state = _port_state_from_jax(_jax_state(npp, opt), opt)
    engine = CheckpointEngine(ckpt_dir, name=uniq("z1"))
    try:
        assert engine.save_to_storage(7, state)
        assert engine.wait_for_persist(7, timeout=30)
    finally:
        engine.close()
    assert export_dcp(ckpt_dir, str(tmp_path / "dcp")) == 7
    step, tree = import_dcp(str(tmp_path / "dcp"))
    assert step == 7 and set(tree) == {"opt_state", "params", "step"}
    step, got = import_dcp(str(tmp_path / "dcp"),
                           target=_fresh_port_state(npp, opt))
    assert step == 7
    assert_equal(state, got)
    assert export_dcp(str(tmp_path / "none"), str(tmp_path / "x")) == -1
