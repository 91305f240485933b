"""The port's restart path against the JAX package's, on the CPU.

- The restore prefetch (``CheckpointEngine.start_prefetch`` ->
  ``finish_restore``) restores, from shm and from disk, the state the
  serial ``load`` restores, leaf for leaf; from a shard on disk it also
  restores what the JAX engine's ``finish_restore`` restores from the
  same shard (shards cross between the packages since the port's
  flash checkpoint).
- ``RestartCoordinator`` emits the JAX coordinator's spans with the same
  nesting (``restart_path`` around ``rendezvous_wait``,
  ``restore_prefetch``, ``checkpoint_restore`` and ``finish_restore``),
  and reads ``DLROVER_TPU_RESTART_OVERLAP`` as the JAX one does.
- A prefetch that fails (resolving what is there, or staging it) gives
  the serial result, through the serial path.
- The ``Trainer`` starts the prefetch unless ``DLROVER_TPU_PREV_WORLD``
  names another world, as the JAX ``Trainer`` does.
- The prefetch publishes a shm slot's leaves as ``FileLeaf``s and the
  restore reads them from the segment's file straight into the target.
- The pieces under the prefetch: ``parallel_pread``, ``parallel_touch``,
  ``FileRange`` batches, ``slot_file`` and ``open_slot``.

Every comparison is exact.
"""

import os
import shutil
import tempfile
import threading
import uuid

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.observability import events as jevents  # noqa: E402
from dlrover_tpu.trainer import restart_path as jrp  # noqa: E402
from dlrover_tpu.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine as JaxEngine,
)
from dlrover_tpu_torch.agent.ckpt_saver import (  # noqa: E402
    AsyncCheckpointSaver,
)
from dlrover_tpu_torch.agent.ckpt_shm import (  # noqa: E402
    FileLeaf,
    FileRange,
    SharedMemoryHandler,
    _batches,
    _flatten_keyed,
    restore_to_target,
)
from dlrover_tpu_torch.common import multi_process, parallel_io  # noqa: E402
from dlrover_tpu_torch.observability import events as tevents  # noqa: E402
from dlrover_tpu_torch.trainer import restart_path as trp  # noqa: E402
from dlrover_tpu_torch.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)


@pytest.fixture(autouse=True)
def _sockets(monkeypatch):
    """Short socket dirs of this test's own for both packages (AF_UNIX
    paths end at 107 bytes)."""
    d = tempfile.mkdtemp(prefix="drp", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d + "/t")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", d + "/j")
    yield
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def ckpt_dir():
    d = tempfile.mkdtemp(prefix="drc", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def agent():
    """The saver an agent hosts, in this process: the shm snapshots
    outlive each engine."""
    factory = AsyncCheckpointSaver.start_async_saving_ckpt(
        install_signal_handlers=False)
    yield
    saver = AsyncCheckpointSaver.get_ckpt_saver()
    if saver is not None:
        saver.close(unlink=True)
    AsyncCheckpointSaver._instance = None
    factory.close()


def uniq(tag: str) -> str:
    return f"{tag}{uuid.uuid4().hex[:8]}"


def make_numpy_state(seed=0):
    """A state of distinct values: fp32, bf16 (as JAX holds it), int8, a
    scalar step, large enough that the copies run on the pool."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((512, 4096)).astype(np.float32),
            "b": rng.standard_normal(4096).astype(np.float32),
        },
        "opt": {"q": rng.integers(-128, 127, (2048, 4096),
                                  dtype=np.int8)},
        "step": np.asarray(7, np.int32),
    }


def torch_state(npst, bf16=("b",)):
    def conv(path, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if path[-1] in bf16 else t

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return conv(path, node)

    return walk(npst)


def zeros_like(state):
    if isinstance(state, dict):
        return {k: zeros_like(v) for k, v in state.items()}
    return torch.zeros_like(state)


def bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 compared as bits, on either side)."""
    if torch.is_tensor(x):
        return x.detach().contiguous().view(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _keyed(tree):
    """[(keypath, leaf)]: a state, or the {keypath: tensor} a restore
    with no target returns."""
    if isinstance(tree, dict) and all(
            isinstance(k, str) and k.startswith("[") for k in tree):
        return sorted(tree.items())
    return sorted(_flatten_keyed(tree), key=lambda kv: kv[0])


def assert_same(a, b):
    fa, fb = _keyed(a), _keyed(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert np.array_equal(bits(x), bits(y)), k


def restore_both(ckpt, name, target_fn, with_target=True):
    """(prefetch result, load result) of two fresh engines."""
    out = []
    for serial in (False, True):
        eng = CheckpointEngine(ckpt, name=name)
        target = target_fn() if with_target else None
        try:
            if serial:
                got = eng.load(target=target)
            else:
                pf = eng.start_prefetch()
                got = eng.finish_restore(pf, target=target)
            out.append((got, list(eng.io_log)))
        finally:
            eng.close()
    return out


# ------------------------------------------- prefetch == load == JAX's


@pytest.mark.parametrize("with_target", [True, False])
def test_prefetch_from_shm_equals_the_serial_load(agent, ckpt_dir,
                                                  with_target):
    state = torch_state(make_numpy_state())
    name = uniq("s")
    eng = CheckpointEngine(ckpt_dir, name=name)
    try:
        assert eng.save_to_memory(7, state)
    finally:
        eng.close()
    (pre, pre_log), (ser, ser_log) = restore_both(
        ckpt_dir, name, lambda: zeros_like(state), with_target)
    assert pre[0] == ser[0] == 7
    assert_same(pre[1], ser[1])
    assert_same(pre[1], state)
    assert pre_log[0][:2] == ser_log[0][:2] == ("restore_shm", 7)
    # no view of the segment is handed out
    for _k, v in _flatten_keyed(pre[1]):
        if torch.is_tensor(v) and v.numel():
            seg = SharedMemoryHandler(0, name=name)
            try:
                seg.attach()
                base = np.frombuffer(seg._shm.buf, np.uint8).ctypes.data
                size = seg.segment_size
            finally:
                seg.close()
            assert not base <= v.data_ptr() < base + size


def test_prefetch_from_disk_equals_load_and_the_jax_engine(ckpt_dir):
    npst = make_numpy_state(1)
    jst = {"params": {"w": jnp.asarray(npst["params"]["w"]),
                      "b": jnp.asarray(npst["params"]["b"], jnp.bfloat16)},
           "opt": {"q": jnp.asarray(npst["opt"]["q"])},
           "step": jnp.asarray(npst["step"])}
    jeng = JaxEngine(ckpt_dir, name=uniq("j"))
    try:
        assert jeng.save_to_storage(7, jst)
        assert jeng.wait_for_persist(7, timeout=30)
    finally:
        jeng.close()
    # the JAX engine's overlapped restore of the shard
    jeng = JaxEngine(ckpt_dir, name=uniq("j"))
    try:
        pf = jeng.start_prefetch()
        jstep, jgot = jeng.finish_restore(
            pf, target={"params": {"w": jnp.zeros((512, 4096)),
                                   "b": jnp.zeros(4096, jnp.bfloat16)},
                        "opt": {"q": jnp.zeros((2048, 4096), jnp.int8)},
                        "step": jnp.asarray(0, jnp.int32)})
    finally:
        jeng.close()
    state = torch_state(npst)
    (pre, pre_log), (ser, ser_log) = restore_both(
        ckpt_dir, uniq("d"), lambda: zeros_like(state))
    assert jstep == pre[0] == ser[0] == 7
    assert pre_log[0][:2] == ser_log[0][:2] == ("restore_storage", 7)
    assert_same(pre[1], ser[1])
    assert_same(pre[1], jgot)


# ------------------------------------------------------ spans, switch


def _timeline(monkeypatch, path):
    monkeypatch.setenv("DLROVER_TPU_EVENTS_FILE", path)
    for mod in (tevents, jevents):
        monkeypatch.setattr(mod, "_default_logger", None)


def _nesting(evs):
    """[(name, ph, inside restart_path)] in the order written, restart
    path's own records included."""
    b = next(e["wall"] for e in evs
             if e["name"] == "restart_path" and e["ph"] == "B")
    end = next(e["wall"] for e in evs
               if e["name"] == "restart_path" and e["ph"] == "E")
    out = []
    for e in evs:
        start = e["wall"]
        stop = start + e.get("dur", 0.0)
        out.append((e["name"], e["ph"],
                    b <= start and stop <= end + 1e-6))
    return sorted(out)


def test_spans_and_nesting_equal_the_jax_coordinator(monkeypatch, tmp_path,
                                                     ckpt_dir):
    npst = make_numpy_state(2)
    # one shard on disk, written by the JAX engine, restored by both
    jeng = JaxEngine(ckpt_dir, name=uniq("j"))
    try:
        assert jeng.save_to_storage(3, {k: v for k, v in npst.items()
                                        if k != "step"})
        assert jeng.wait_for_persist(3, timeout=30)
    finally:
        jeng.close()
    runs = {}
    for pkg, mod, make in (
            ("jax", jrp, lambda: JaxEngine(ckpt_dir, name=uniq("j"))),
            ("torch", trp, lambda: CheckpointEngine(ckpt_dir,
                                                    name=uniq("t")))):
        path = str(tmp_path / f"{pkg}.jsonl")
        _timeline(monkeypatch, path)
        eng = make()
        try:
            coord = mod.RestartCoordinator(eng).start()
            with coord.rendezvous_wait():
                pass
            step, _ = coord.finish_restore()
            assert step == 3
        finally:
            eng.close()
        read = (jevents if pkg == "jax" else tevents).read_events
        runs[pkg] = [e for e in read(path) if e["name"] in (
            "restart_path", "rendezvous_wait", "restore_prefetch",
            "checkpoint_restore", "finish_restore")]
    assert _nesting(runs["torch"]) == _nesting(runs["jax"])
    assert {e["name"] for e in runs["torch"]} == {
        "restart_path", "rendezvous_wait", "restore_prefetch",
        "checkpoint_restore", "finish_restore"}


@pytest.mark.parametrize("value", [None, "1", "0", "false", "OFF", " no "])
def test_overlap_switch_reads_as_the_jax_one(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(trp.OVERLAP_ENV, raising=False)
    else:
        monkeypatch.setenv(trp.OVERLAP_ENV, value)
    assert trp.OVERLAP_ENV == jrp.OVERLAP_ENV
    assert trp.overlap_enabled() == jrp.overlap_enabled()
    assert trp.RestartCoordinator().overlap == jrp.RestartCoordinator().overlap


def test_overlap_off_restores_serially(monkeypatch, tmp_path, agent,
                                       ckpt_dir):
    state = torch_state(make_numpy_state(3))
    name = uniq("o")
    eng = CheckpointEngine(ckpt_dir, name=name)
    try:
        assert eng.save_to_memory(5, state)
    finally:
        eng.close()
    path = str(tmp_path / "ev.jsonl")
    _timeline(monkeypatch, path)
    monkeypatch.setenv(trp.OVERLAP_ENV, "0")
    eng = CheckpointEngine(ckpt_dir, name=name)
    try:
        coord = trp.RestartCoordinator(eng).start()
        assert coord.prefetch is None
        step, got = coord.finish_restore(target=zeros_like(state))
    finally:
        eng.close()
    assert step == 5
    assert_same(got, state)
    names = [e["name"] for e in tevents.read_events(path)]
    assert "checkpoint_restore" in names
    assert not {"restart_path", "restore_prefetch",
                "finish_restore"} & set(names)


# -------------------------------------------------- failure -> serial


@pytest.mark.parametrize("where", ["availability", "staging"])
def test_a_failed_prefetch_gives_the_serial_result(monkeypatch, tmp_path,
                                                   agent, ckpt_dir, where):
    state = torch_state(make_numpy_state(4))
    name = uniq("f")
    eng = CheckpointEngine(ckpt_dir, name=name)
    try:
        assert eng.save_to_memory(9, state)
    finally:
        eng.close()
    path = str(tmp_path / "ev.jsonl")
    _timeline(monkeypatch, path)
    eng = CheckpointEngine(ckpt_dir, name=name)
    if where == "availability":
        real = eng._latest_storage_step
        calls = []

        def flaky(*a, **k):
            calls.append(1)
            if len(calls) == 1:  # the prefetch thread's call
                raise OSError("storage unreachable")
            return real(*a, **k)

        monkeypatch.setattr(eng, "_latest_storage_step", flaky)
    else:
        # the staging fails on the prefetch thread; the serial load on
        # this thread reads the segment
        real_slot, real_load = (SharedMemoryHandler.slot_file,
                                SharedMemoryHandler.load_state)

        def on_prefetch_thread(real):
            def broken(self, *a, **k):
                if threading.current_thread().name == (
                        "ckpt-restore-prefetch"):
                    raise OSError("segment gone")
                return real(self, *a, **k)

            return broken

        monkeypatch.setattr(SharedMemoryHandler, "slot_file",
                            on_prefetch_thread(real_slot))
        monkeypatch.setattr(SharedMemoryHandler, "load_state",
                            on_prefetch_thread(real_load))
    try:
        pf = eng.start_prefetch()
        pf.join()
        assert (pf.error is not None) == (where == "availability")
        assert (pf.candidate(9) is None)
        step, got = eng.finish_restore(pf, target=zeros_like(state))
    finally:
        eng.close()
    assert step == 9
    assert_same(got, state)
    restores = [e for e in tevents.read_events(path)
                if e["name"] == "checkpoint_restore"]
    assert [e["labels"].get("stage") for e in restores] == [None]


# -------------------------------------------- the Trainer's prefetch


@pytest.mark.parametrize("prev_world,prefetch", [
    ("0", True), ("1", True), ("2", False)])
def test_trainer_prefetches_unless_the_world_changed(monkeypatch, agent,
                                                     ckpt_dir, prev_world,
                                                     prefetch):
    from dlrover_tpu_torch.accelerate import auto_accelerate
    from dlrover_tpu_torch.models import llama as tl
    from dlrover_tpu_torch.optimizers import AGD
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    result = auto_accelerate(
        loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
        optimizer=lambda ps: AGD(ps, lr=1e-3),
        init_params_fn=lambda gen, dev: tl.init_params(
            cfg, gen, dev, dtype=torch.float32),
        device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17), dtype=np.int32)}

    def run(steps):
        trainer = Trainer(result, TrainingArgs(
            max_steps=steps, log_interval=0, checkpoint_dir=ckpt_dir,
            save_memory_interval=1, save_storage_interval=100),
            lambda: iter([batch] * steps))
        return trainer

    first = run(2)
    first.train()
    monkeypatch.setenv("DLROVER_TPU_PREV_WORLD", prev_world)
    second = run(3)
    assert (second._restart_coord is not None) == prefetch
    assert second.restore() == 2
    assert ("prefetch_start" in second.marks) == prefetch
    assert second._engine.io_log[0][:2] == ("restore_shm", 2)
    assert_same(second.state["params"], first.state["params"])
    second.train()


# ------------------------------------------------ the pieces under it


def test_parallel_pread_and_touch(tmp_path):
    rng = np.random.default_rng(5)
    blob = rng.integers(0, 255, 40 << 20, dtype=np.uint8)
    path = tmp_path / "blob"
    path.write_bytes(blob.tobytes())
    fd = os.open(path, os.O_RDONLY)
    try:
        for off, n, workers in ((0, 40 << 20, 8), (12345, 30 << 20, 3),
                                (7, 100, 1)):
            dst = np.zeros(n, np.uint8)
            assert parallel_io.parallel_pread(fd, dst, off,
                                              workers=workers) == n
            assert np.array_equal(dst, blob[off:off + n])
        with pytest.raises(EOFError):
            parallel_io.parallel_pread(fd, np.zeros(64, np.uint8),
                                       (40 << 20) - 10)
    finally:
        os.close(fd)
    before = blob.copy()
    assert parallel_io.parallel_touch(blob[3:]) == blob.size - 3
    assert parallel_io.parallel_touch(blob[:5], workers=1) == 5
    assert np.array_equal(before, blob)


def test_file_ranges_batch_as_host_buffers():
    """``_batches`` cuts a ``FileRange`` where it cuts a host buffer."""
    dev = [torch.zeros(10, dtype=torch.uint8),
           torch.zeros(7, dtype=torch.uint8)]
    host = [np.arange(10, dtype=np.uint8), np.arange(100, 107,
                                                     dtype=np.uint8)]
    files = [FileRange(3, 0, 10), FileRange(3, 100, 7)]
    a = list(_batches(list(zip(dev, host)), 8))
    b = list(_batches(list(zip(dev, files)), 8))
    assert len(a) == len(b) == 3
    for ba, bb in zip(a, b):
        assert [(d.numel(), at) for d, _h, at in ba] == [
            (d.numel(), at) for d, _f, at in bb]
        # the host slice starts at the byte the file range starts at
        assert [(int(h[0]), h.nbytes) for _d, h, _ in ba] == [
            (f.offset, f.nbytes) for _d, f, _ in bb]
    assert files[0][2:9].offset == 2 and files[0][2:9].nbytes == 7


def test_slot_file_preads_the_bytes_load_state_views(agent):
    state = torch_state(make_numpy_state(6))
    name = uniq("p")
    handler = SharedMemoryHandler(0, name=name, host=False)
    eng = CheckpointEngine(tempfile.gettempdir(), name=name)
    try:
        assert eng.save_to_memory(4, state)
        path, step, base, specs = handler.slot_file(4)
        assert step == 4 and os.path.basename(path).endswith(f"{name}_0")
        _got, views = handler.load_state(copy=False, step=4)
        fd = os.open(path, os.O_RDONLY)
        try:
            for key, _dts, _shape, off, nbytes in specs:
                dst = np.zeros(int(nbytes), np.uint8)
                parallel_io.parallel_pread(fd, dst, base + int(off))
                assert np.array_equal(dst, bits(views[key])), key
        finally:
            os.close(fd)
        assert handler.slot_file(99) is None
        del views, _got
    finally:
        handler.close()
        eng.close()


def test_open_slot_gives_file_leaves_of_the_slot(agent):
    state = torch_state(make_numpy_state(7))
    name = uniq("l")
    handler = SharedMemoryHandler(0, name=name, host=False)
    eng = CheckpointEngine(tempfile.gettempdir(), name=name)
    try:
        assert eng.save_to_memory(3, state)
        fd, step, leaves = handler.open_slot(3)
        try:
            assert step == 3
            want = dict(_flatten_keyed(state))
            assert sorted(leaves) == sorted(want)
            for key, leaf in leaves.items():
                got = leaf.read()
                assert got.dtype == leaf.dtype == torch.as_tensor(
                    want[key]).dtype
                assert np.array_equal(bits(got), bits(want[key])), key
            # a CPU target takes them as restore_to_target values
            target = zeros_like(state)
            restore_to_target(target, leaves)
            assert_same(target, state)
        finally:
            os.close(fd)
        assert handler.open_slot(99) is None
    finally:
        handler.close()
        eng.close()


def test_the_shm_prefetch_publishes_the_slot_s_file_leaves(
        monkeypatch, tmp_path, agent, ckpt_dir):
    """The prefetch opens the slot and copies none of it: the restore
    reads every leaf from the segment's file."""
    state = torch_state(make_numpy_state(8))
    name = uniq("h")
    eng = CheckpointEngine(ckpt_dir, name=name)
    try:
        assert eng.save_to_memory(6, state)
    finally:
        eng.close()
    path = str(tmp_path / "ev.jsonl")
    _timeline(monkeypatch, path)
    eng = CheckpointEngine(ckpt_dir, name=name)
    try:
        pf = eng.start_prefetch()
        pf.join()
        cand = pf.candidate(6)
        assert cand.source == "shm"
        assert all(isinstance(v, FileLeaf) for v in cand.arrays.values())
        step, got = eng.finish_restore(pf, target=zeros_like(state))
        assert cand.arrays == {} and cand._fd is None  # released
    finally:
        eng.close()
    assert step == 6
    assert_same(got, state)
    evs = {e["name"]: e for e in tevents.read_events(path)}
    total = sum(int(torch.as_tensor(v).nbytes)
                for _k, v in _flatten_keyed(state))
    assert evs["restore_prefetch"]["labels"]["bytes"] == total
    assert evs["finish_restore"]["labels"]["bytes"] == total
