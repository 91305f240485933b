"""The port's input data plane against the JAX package's, on the CPU.

- ``ElasticDistributedSampler`` and ``ElasticBatchIterator`` give the
  JAX package's index streams for the same seed, world and rank, also
  across a world resize through ``state_dict``/``load_state_dict``.
- ``ShardingClient`` against the port's master gives the shard sequence
  the JAX client gets from the JAX master, with a worker lost mid-epoch
  and its shard handed to the survivor, and the shard checkpoint round
  trip.
- A batch the JAX ``ShmBatchWriter`` wrote reads back byte for byte
  through the port's ``ShmDataLoader``, and the other way round.
- ``coworker.encode_batch``/``decode_batch`` round-trip against the JAX
  functions, and ``ElasticDataLoader`` yields the JAX loader's batches.
- ``device_prefetch`` yields the serial order, pipelined and not, cut to
  a rank's rows by a ``BatchSharding``, re-raises an iterator's
  exception, and a slow iterator leaves ``data_stall`` spans with the
  reference's labels (``stage=host_fetch``) in the events file.
"""

import os
import shutil
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from dlrover_tpu.data import coworker as jcw  # noqa: E402
from dlrover_tpu.data import shm_dataloader as jshm  # noqa: E402
from dlrover_tpu.data.elastic_dataloader import (  # noqa: E402
    ElasticDataLoader as JLoader,
)
from dlrover_tpu.trainer.elastic import sampler as jsampler  # noqa: E402
from dlrover_tpu_torch.common import multi_process  # noqa: E402
from dlrover_tpu_torch.data import coworker as tcw  # noqa: E402
from dlrover_tpu_torch.data import shm_dataloader as tshm  # noqa: E402
from dlrover_tpu_torch.data.elastic_dataloader import (  # noqa: E402
    ElasticDataLoader as TLoader,
)
from dlrover_tpu_torch.data.prefetch import device_prefetch  # noqa: E402
from dlrover_tpu_torch.observability import events as tevents  # noqa: E402
from dlrover_tpu_torch.parallel.sharding import BatchSharding  # noqa: E402
from dlrover_tpu_torch.trainer.elastic import sampler as tsampler  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def socket_dir(monkeypatch):
    """One short socket dir for both packages: a ring made by one
    package's loader is attached by the other's writer."""
    d = tempfile.mkdtemp(prefix="dtd", dir="/tmp")
    monkeypatch.setenv(multi_process.SOCKET_DIR_ENV, d)
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", d)
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------- sampler


def _stream(mod, size, world, rank, seed, shuffle, drop_last, epoch=0,
            take=None, state=None):
    s = mod.ElasticDistributedSampler(size, world, rank, shuffle=shuffle,
                                      seed=seed, drop_last=drop_last)
    s.set_epoch(epoch)
    if state is not None:
        s.load_state_dict(state)
    out = []
    for idx in s:
        out.append(idx)
        if take is not None and len(out) == take:
            break
    return out, s.state_dict(), len(s)


@pytest.mark.parametrize("size,world,seed,shuffle,drop_last", [
    (37, 4, 0, True, False), (37, 4, 3, True, True),
    (40, 2, 1, False, False), (9, 8, 5, True, False)])
def test_sampler_streams_equal_jax(size, world, seed, shuffle, drop_last):
    for rank in range(world):
        for epoch in (0, 2):
            got = _stream(tsampler, size, world, rank, seed, shuffle,
                          drop_last, epoch)
            want = _stream(jsampler, size, world, rank, seed, shuffle,
                           drop_last, epoch)
            assert got == want


def test_sampler_resumes_across_a_world_resize_as_jax_does():
    """4 ranks consume 3 indices each, the world shrinks to 3 and then
    grows to 6 through ``state_dict``: every rank's stream equals the
    JAX sampler's."""
    for mod_pair in ((tsampler, jsampler),):
        states = {}
        for mod in mod_pair:
            firsts = [_stream(mod, 50, 4, r, 7, True, False, take=3)
                      for r in range(4)]
            state = firsts[0][1]
            rest3 = [_stream(mod, 50, 3, r, 7, True, False, take=5,
                             state=state) for r in range(3)]
            state3 = rest3[0][1]
            rest6 = [_stream(mod, 50, 6, r, 7, True, False, state=state3)
                     for r in range(6)]
            states[mod.__name__] = (firsts, rest3, rest6)
        got, want = states[tsampler.__name__], states[jsampler.__name__]
        assert got == want
        # the resize hands out every remaining index once
        (_, rest3, rest6) = got
        assert len({i for s, _, _ in rest6 for i in s}) > 0


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_equals_jax(drop_last):
    def run(mod):
        s = mod.ElasticDistributedSampler(23, 2, 1, seed=4)
        it = mod.ElasticBatchIterator(s, 4, drop_last=drop_last)
        return [b.tolist() for b in it], len(it), s.state_dict()

    assert run(tsampler) == run(jsampler)
    st = tsampler.state_dict_with_sampler(
        {"w": 1}, tsampler.ElasticDistributedSampler(10))
    assert st == jsampler.state_dict_with_sampler(
        {"w": 1}, jsampler.ElasticDistributedSampler(10))


# -------------------------------------------------------- sharding client


def _shard_sequence(master_mod, client_mod, sharding_mod):
    """Two workers share a 10-batch dataset; worker 1 takes one shard,
    dies before acking it (its task is reported failed), and worker 0
    drains the rest, the lost shard included."""
    from dlrover_tpu_torch.common.env import get_free_port

    m = master_mod.LocalJobMaster(get_free_port(), node_num=2)
    m.prepare()
    try:
        clients = [client_mod.MasterClient(m.addr, node_id=i)
                   for i in range(2)]
        w = [sharding_mod.ShardingClient(
            "ds", batch_size=4, dataset_size=40, num_epochs=1,
            num_minibatches_per_shard=2, client=c, prefetch_tasks=False)
            for c in clients]
        seq = []
        s0 = w[0].fetch_shard()
        seq.append((0, s0.start, s0.end))
        w[0].report_batch_done()
        s1 = w[1].fetch_shard()
        seq.append((1, s1.start, s1.end))
        ckpt = w[0].get_shard_checkpoint()
        lost = w[1]._pending[0].task_id
        # the master answers a failure report with False (not a
        # success) and requeues the shard
        seq.append(("failed", w[1].report_task_failed(lost, "worker lost")))
        while True:
            s = w[0].fetch_shard(wait_interval=0.05)
            if s is None:
                break
            seq.append((0, s.start, s.end))
            w[0].report_batch_done()
        assert w[0].restore_shard_checkpoint(ckpt)
        return seq, bool(ckpt)
    finally:
        m.stop()


def test_sharding_client_shard_sequence_equals_jax():
    from dlrover_tpu.agent import master_client as jmc
    from dlrover_tpu.master import master as jmaster
    from dlrover_tpu.trainer import sharding as jsh
    from dlrover_tpu_torch.agent import master_client as tmc
    from dlrover_tpu_torch.master import master as tmaster
    from dlrover_tpu_torch.trainer import sharding as tsh

    got = _shard_sequence(tmaster, tmc, tsh)
    want = _shard_sequence(jmaster, jmc, jsh)
    assert got == want
    seq, has_ckpt = got
    assert has_ckpt
    # every record once, the lost shard re-served to the survivor
    served = [s for s in seq if s[0] != "failed"]
    covered = sorted((a, b) for _, a, b in served[:1] + served[2:])
    assert covered[0][0] == 0 and covered[-1][1] == 40
    assert served[1][1:] in [(a, b) for _, a, b in served[2:]]


def test_sharding_client_prefetch_keeps_the_order():
    from dlrover_tpu_torch.common.messages import DataShard, Task, TaskType
    from dlrover_tpu_torch.trainer.sharding import ShardingClient

    class Stub:
        def __init__(self, n):
            self.i, self.n, self.threads = 0, n, []

        def get_task(self, name):
            self.threads.append(__import__("threading").current_thread().name)
            i, self.i = self.i, self.i + 1
            if i < self.n:
                return Task(task_id=i, task_type=TaskType.TRAINING,
                            shard=DataShard(name="d", start=4 * i,
                                            end=4 * i + 4))
            return Task()

    stub = Stub(5)
    c = ShardingClient("d", 4, client=stub, prefetch_tasks=True)
    assert [s.start for s in c.iter_shards()] == [0, 4, 8, 12, 16]
    assert any("shard-prefetch" in t for t in stub.threads)


# ----------------------------------------------------------- shm rings


def _spec(mod):
    return mod.BatchSpec({"tokens": ((4, 9), "int32"),
                          "mask": ((4, 8), "float32")})


def _batches(n):
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, 1000, (4, 9)).astype(np.int32),
             "mask": rng.random((4, 8)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("reader,writer", [("torch", "jax"),
                                           ("jax", "torch")])
def test_shm_batches_cross_byte_for_byte(socket_dir, reader, writer):
    mods = {"torch": tshm, "jax": jshm}
    name = f"r{uuid.uuid4().hex[:8]}"
    loader = mods[reader].ShmDataLoader(name, _spec(mods[reader]),
                                        num_slots=2, timeout=30)
    try:
        w = mods[writer].ShmBatchWriter(name)
        sent = _batches(3)
        got = []
        for b in sent:
            assert w.put(b, timeout=30)
            got.append(loader.next_batch())
        w.close()
        assert loader.next_batch() is None
        for a, b in zip(sent, got):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
    finally:
        loader.close()


def test_coworker_encoding_round_trips_against_jax():
    b = _batches(1)[0]
    for enc, dec in ((tcw.encode_batch, jcw.decode_batch),
                     (jcw.encode_batch, tcw.decode_batch)):
        out = dec(enc(b))
        assert {k: v.tobytes() for k, v in out.items()} == {
            k: v.tobytes() for k, v in b.items()}
    assert tcw.encode_batch(b) == jcw.encode_batch(b)


def test_elastic_dataloader_equals_jax(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_FILE", "/nonexistent")

    def read(idx):
        return {"x": np.asarray(idx, np.int64) * 3}

    def run(loader_cls, smod, pipeline):
        s = smod.ElasticDistributedSampler(30, 2, 0, seed=2)
        ld = loader_cls(30, 4, read, sampler=s, num_workers=2,
                        pipeline=pipeline)
        return [b["x"].tolist() for b in ld], ld.state_dict()

    for pipeline in (False, True):
        assert run(TLoader, tsampler, pipeline) == run(
            JLoader, jsampler, pipeline)


# ------------------------------------------------------- device prefetch


def _host_batches(n, rows=4):
    for i in range(n):
        yield {"tokens": np.full((rows, 3), i, np.int32),
               "w": np.arange(rows, dtype=np.float32) + 10 * i}


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_device_prefetch_keeps_the_serial_order(pipelined, size):
    it = device_prefetch(_host_batches(7), size=size, pipelined=pipelined,
                         device="cpu")
    got = list(it)
    assert [int(b["tokens"][0, 0]) for b in got] == list(range(7))
    assert all(isinstance(b["w"], torch.Tensor) for b in got)
    assert [h["bytes"] for h in it.h2d_times()] == [4 * 3 * 4 + 4 * 4] * 7


@pytest.mark.parametrize("pipelined", [False, True])
def test_device_prefetch_takes_the_ranks_rows(pipelined):
    for index in range(4):
        sh = BatchSharding(4, index, CPU)
        got = list(device_prefetch(_host_batches(3, rows=8), sharding=sh,
                                   pipelined=pipelined))
        for i, b in enumerate(got):
            assert b["w"].tolist() == [10 * i + 2 * index,
                                       10 * i + 2 * index + 1]
    with pytest.raises(ValueError, match="does not split"):
        list(device_prefetch(_host_batches(1, rows=6),
                             sharding=BatchSharding(4, 0, CPU)))


@pytest.mark.parametrize("pipelined", [False, True])
def test_device_prefetch_reraises_the_iterators_error(pipelined):
    def bad():
        yield from _host_batches(3)
        raise KeyError("corrupt record")

    # the error surfaces where the serial loop meets it: after every
    # batch staged before it, whatever the number in flight
    for size in (1, 2, 4):
        got = []
        with pytest.raises(KeyError, match="corrupt record"):
            for b in device_prefetch(bad(), size=size, pipelined=pipelined,
                                     device="cpu"):
                got.append(int(b["tokens"][0, 0]))
        assert got == [0, 1, 2]


def test_device_prefetch_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_prefetch(_host_batches(1))


@pytest.mark.parametrize("pipelined", [False, True])
def test_slow_iterator_leaves_data_stall_spans(monkeypatch, tmp_path,
                                               pipelined):
    path = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("DLROVER_TPU_EVENTS_FILE", path)
    monkeypatch.setattr(tevents, "_default_logger", None)

    def slow():
        for b in _host_batches(3):
            time.sleep(0.08)
            yield b

    assert len(list(device_prefetch(slow(), size=1, pipelined=pipelined,
                                    device="cpu"))) == 3
    stalls = [e for e in tevents.read_events(path)
              if e["name"] == "data_stall"]
    assert stalls, tevents.read_events(path)
    assert {e["labels"]["stage"] for e in stalls} == {"host_fetch"}
    assert all(e["dur"] >= 0.05 for e in stalls)


def test_every_prefetcher_of_a_device_copies_on_one_stream(monkeypatch):
    """The copy stream is made once per device: a prefetcher made after
    another reuses the blocks the caching allocator keeps for it."""
    from dlrover_tpu_torch.data import prefetch

    made = []

    def fake_stream(device):
        made.append(device)
        return object()

    monkeypatch.setattr(prefetch, "_COPY_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", fake_stream)
    cards = [torch.device("cuda", i) for i in (0, 1)]
    first = [prefetch.copy_stream(d) for d in cards]
    again = [prefetch.copy_stream(d) for d in cards]
    assert again == first and first[0] is not first[1]
    assert made == cards
