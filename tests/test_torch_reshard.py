"""The port's reshard layer against the JAX package's, on the CPU.

- ``iter_copy_runs``, ``LeafLayout`` and the layout constructors give
  the JAX package's answers on the same boxes.
- ``plan_reshard`` on the shards of a simulated 8-process job, read onto
  4 (and 8 -> 8, 4 -> 8), equals the JAX package's plan on the same
  files, run by run.
- The 8 -> 4 -> 8 round trip through the port's engines ends bit for bit
  where an uninterrupted run ends (``tests/test_reshard.py``'s pin).
- Layout gating of shm slots, the crash flush's header, the coverage and
  mixed-step errors, and the ``reshard`` span.
"""

import os
import shutil
import tempfile
import uuid

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from dlrover_tpu.trainer.checkpoint import reshard as JR  # noqa: E402
from dlrover_tpu_torch.agent.ckpt_shm import SharedMemoryHandler  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.common.storage import PosixDiskStorage  # noqa: E402
from dlrover_tpu_torch.observability import events as ev  # noqa: E402
from dlrover_tpu_torch.trainer.checkpoint import reshard as R  # noqa: E402
from dlrover_tpu_torch.trainer.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)


@pytest.fixture(autouse=True)
def _port_sockets(monkeypatch):
    d = tempfile.mkdtemp(prefix="dtr", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d)
    yield
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def ckpt_dir():
    d = tempfile.mkdtemp(prefix="dtk", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def uniq(tag: str) -> str:
    """A segment name of this test's own: shm segments and their
    sockets are machine-wide, and two runs of one test side by side
    must not attach to each other's."""
    return f"{tag}{uuid.uuid4().hex[:8]}"


# ------------------------------------------------------------ box math


@pytest.mark.parametrize("src,dst,itemsize", [
    (((0, 0), (4, 6)), ((0, 0), (4, 6)), 4),
    (((), ()), ((), ()), 8),
    (((0, 0), (4, 4)), ((0, 2), (4, 4)), 1),
    (((6, 0), (3, 5)), ((6, 0), (6, 5)), 4),
    (((9, 0), (3, 5)), ((6, 0), (6, 5)), 4),
    (((2, 0, 0), (3, 3, 2)), ((4, 0, 0), (3, 3, 2)), 2),
    (((0, 1, 0), (5, 2, 7)), ((2, 0, 3), (2, 3, 4)), 2),
])
def test_copy_runs_match_jax(src, dst, itemsize):
    got = list(R.iter_copy_runs(src[0], src[1], dst[0], dst[1], itemsize))
    want = list(JR.iter_copy_runs(src[0], src[1], dst[0], dst[1], itemsize))
    assert got == want and got


def test_layouts_match_jax():
    for args in (((4,), (2,), (3,)), ((4, 4), (0,), (4,))):
        with pytest.raises(ValueError):
            R.LeafLayout(*args)
        with pytest.raises(ValueError):
            JR.LeafLayout(*args)
    tree = {"w": torch.zeros(8, 2), "b": torch.zeros(())}
    jtree = {"w": np.zeros((8, 2)), "b": np.zeros(())}
    assert R.replicated_layouts(tree) == JR.replicated_layouts(jtree)
    assert (R.axis0_layouts(tree, rank=3, world=4)
            == JR.axis0_layouts(jtree, rank=3, world=4))
    assert R.derive_layouts(tree) == R.replicated_layouts(tree)


# ------------------------------------------------ simulated worlds


def _global(rows=32, cols=6):
    """An optimizer-shaped global state: fp32 params and momentum, a
    bf16 copy, fp64 second moment, a replicated int32 step."""
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
    return {
        "p": p,
        "m": torch.from_numpy(
            rng.standard_normal((rows, cols)).astype(np.float32)),
        "h": p.to(torch.bfloat16),
        "v": torch.from_numpy(np.abs(rng.standard_normal((rows, cols)))),
        "step": torch.tensor(100, dtype=torch.int32),
    }


def _rank_tree(g, rank, world):
    per = g["p"].shape[0] // world
    out = {k: v[rank * per:(rank + 1) * per].clone()
           for k, v in g.items() if k != "step"}
    out["step"] = g["step"].clone()
    return out


def _rank_layouts(tree, rank, world):
    lay = R.axis0_layouts({k: v for k, v in tree.items() if k != "step"},
                          rank, world)
    lay.update(R.replicated_layouts({"step": tree["step"]}))
    return lay


def _engines(ckpt_dir, world, name):
    """One engine per simulated rank; rank 0 hosts the saver serving
    every shard's endpoints, so it is built first."""
    name = uniq(name)
    return [CheckpointEngine(checkpoint_dir=ckpt_dir, process_rank=r,
                             process_count=world, local_shard_num=world,
                             name=name, step_sync_fn=max)
            for r in range(world)]


def _close_all(engines):
    for eng in engines[1:]:
        eng.close()
    engines[0].close()


def _save_world(ckpt_dir, g, step, world, name, headers=True):
    engines = _engines(ckpt_dir, world, name)

    def layouts(tree, r):
        return _rank_layouts(tree, r, world) if headers else None

    try:
        for r in range(1, world):
            tree = _rank_tree(g, r, world)
            assert engines[r].save_to_memory(
                step, tree, layouts=layouts(tree, r))
        tree0 = _rank_tree(g, 0, world)
        assert engines[0].save_to_storage(
            step, tree0, layouts=layouts(tree0, 0))
        assert engines[0].wait_for_persist(step, timeout=60)
    finally:
        _close_all(engines)


def _restore_world(ckpt_dir, world, name, g_like):
    engines = _engines(ckpt_dir, world, name)
    per = g_like["p"].shape[0] // world
    out = {k: torch.zeros_like(v) for k, v in g_like.items()}
    steps = set()
    try:
        for r, eng in enumerate(engines):
            target = {k: torch.zeros_like(v) for k, v in
                      _rank_tree(g_like, r, world).items()}
            got, restored = eng.load(
                target=target, layouts=_rank_layouts(target, r, world))
            steps.add(got)
            for k in ("p", "m", "h", "v"):
                out[k][r * per:(r + 1) * per] = restored[k]
            out["step"] = restored["step"]
    finally:
        _close_all(engines)
    assert len(steps) == 1, steps
    return steps.pop(), out


def _assert_same(a, b):
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_8_to_4_to_8_bitwise(ckpt_dir):
    g0 = _global()
    _save_world(ckpt_dir, g0, 5, 8, "w8")
    step, g1 = _restore_world(ckpt_dir, 4, "w4a", g0)
    assert step == 5
    _assert_same(g1, g0)
    # world 4 applies the step an uninterrupted 8-process run would
    g2 = {"p": g1["p"] - 0.01 * g1["m"], "m": 0.9 * g1["m"],
          "h": g1["h"] * 2, "v": 0.99 * g1["v"], "step": g1["step"] + 1}
    _save_world(ckpt_dir, g2, 6, 4, "w4b")
    step, g3 = _restore_world(ckpt_dir, 8, "w8b", g2)
    assert step == 6
    _assert_same(g3, {"p": g0["p"] - 0.01 * g0["m"], "m": 0.9 * g0["m"],
                      "h": g0["h"] * 2, "v": 0.99 * g0["v"],
                      "step": g0["step"] + 1})


def _plans_equal(ours, theirs):
    assert ours[0] == theirs[0]
    assert len(ours[1]) == len(theirs[1])
    for a, b in zip(ours[1], theirs[1]):
        assert (a.key, a.dtype, tuple(a.shape), a.reads, a.nbytes) == (
            b.key, str(b.dtype), tuple(b.shape), b.reads, b.nbytes)


@pytest.mark.parametrize("saved,read", [(8, 4), (8, 8), (4, 8), (8, 1)])
def test_plan_reshard_equals_the_jax_plan(saved, read, ckpt_dir):
    g = _global()
    g.pop("h")  # bf16: numpy reads it only through ml_dtypes, kept apart
    _save_world(ckpt_dir, g, 3, saved, f"p{saved}")
    ckpt = os.path.join(ckpt_dir, "checkpoint-3")
    ours = R.scan_checkpoint_shards(ckpt)
    theirs = JR.scan_checkpoint_shards(ckpt)
    assert [s.rank for s in ours] == list(range(saved))
    for r in range(read):
        want = _rank_layouts(_rank_tree(g, r, read), r, read)
        _plans_equal(R.plan_reshard(ours, want),
                     JR.plan_reshard(theirs, want))
    # and the bytes it streams are the JAX package's
    want = _rank_layouts(_rank_tree(g, read - 1, read), read - 1, read)
    mine = {k: v for kind, k, v in (i for i in R.stream_resharded_leaves(
        ckpt, want) if i[0] == "leaf")}
    jaxs = {k: v for kind, k, v in (i for i in JR.stream_resharded_leaves(
        ckpt, want) if i[0] == "leaf")}
    assert set(mine) == set(jaxs)
    for k in mine:
        assert np.array_equal(mine[k].numpy(), jaxs[k])


# -------------------------------------------------- gating and headers


def test_stale_world_shm_is_excluded_and_headerless_admitted(ckpt_dir):
    eng = CheckpointEngine(checkpoint_dir=ckpt_dir, name=uniq("gate"))
    try:
        tree = {"w": torch.arange(8, dtype=torch.float32)}
        old = R.axis0_layouts(tree, 0, 8)
        assert eng.save_to_memory(2, tree, layouts=old)
        assert eng._usable_shm_steps(R.axis0_layouts(tree, 0, 4)) == []
        assert eng._usable_shm_steps(old) == [2]
        assert eng._usable_shm_steps(None) == [2]
        assert eng.save_to_memory(3, tree)  # headerless
        assert eng._usable_shm_steps(R.replicated_layouts(tree)) == [3]
        bigger = R.axis0_layouts({"w": torch.zeros(16)}, 0, 2)
        assert eng._usable_shm_steps(bigger) == []
    finally:
        eng.close()


def test_crash_flush_header_and_the_errors(ckpt_dir):
    g = torch.arange(16, dtype=torch.float32)
    handler = SharedMemoryHandler(0, name=uniq("hdr"), host=True)
    try:
        tree = {"w": g[:8]}
        handler.save_state(1, tree, layouts=R.axis0_layouts(tree, 0, 2))
        path = os.path.join(ckpt_dir, "shard_0.drckpt")
        assert handler.dump_to_file(path, PosixDiskStorage()) == 32
    finally:
        handler.close(unlink=True)
    info = R.read_shard_header(path)
    assert info.step == 1 and info.layouts["['w']"].global_shape == (16,)
    # rank 1 of 2 (rows 8..16) has no shard
    with pytest.raises(R.ReshardError, match="\\['w'\\]"):
        for _ in R.stream_resharded_leaves(
                ckpt_dir, R.axis0_layouts({"w": g[8:]}, 1, 2)):
            pass
    handler = SharedMemoryHandler(1, name=uniq("hdr1"), host=True)
    try:
        tree = {"w": g[8:]}
        handler.save_state(2, tree, layouts=R.axis0_layouts(tree, 1, 2))
        handler.dump_to_file(os.path.join(ckpt_dir, "shard_1.drckpt"),
                             PosixDiskStorage())
    finally:
        handler.close(unlink=True)
    with pytest.raises(R.ReshardError, match="mixed steps"):
        R.plan_reshard(R.scan_checkpoint_shards(ckpt_dir),
                       R.axis0_layouts({"w": g[:8]}, 0, 2))


def test_reshard_span_and_headerless_shards(ckpt_dir, tmp_path,
                                            monkeypatch):
    events_file = tmp_path / "events.jsonl"
    monkeypatch.setenv(ev.EVENTS_FILE_ENV, str(events_file))
    ev.set_default_event_logger(None)  # re-read the env
    try:
        g = _global(rows=8, cols=4)
        _save_world(ckpt_dir, g, 4, 4, "s4")
        step, g2 = _restore_world(ckpt_dir, 2, "s2", g)
        assert step == 4
        _assert_same(g2, g)
    finally:
        ev.set_default_event_logger(None)
    spans = [e for e in ev.read_events(str(events_file))
             if e["name"] == "reshard"]
    assert len(spans) == 2
    assert {(s["labels"]["from_world"], s["labels"]["to_world"])
            for s in spans} == {(4, 2)}
    assert all(s["labels"]["bytes"] > 0 for s in spans)
    # shards saved without layouts carry no header: they restore on
    # their own world, and a changed world cannot reassemble them
    plain = os.path.join(ckpt_dir, "plain")
    _save_world(plain, g, 4, 4, "h4", headers=False)
    step, g4 = _restore_world(plain, 4, "h4r", g)
    assert step == 4
    _assert_same(g4, g)
    with pytest.raises(RuntimeError, match="unavailable locally"):
        _restore_world(plain, 2, "h2", g)
