"""Elastic dataloader: batch size re-tuned at runtime by the master.

Copy of ``dlrover_tpu/data/elastic_dataloader.py``.

Reference parity: ``dlrover/trainer/torch/elastic/dataloader.py:26``
(``ElasticDataLoader.load_config`` re-reads the JSON config file the
``ParalConfigTuner`` writes — ``elastic_agent/config/
paral_config_tuner.py:30``) so the master's auto-tuned dataloader
parameters take effect without restarting training.

The loader is **pipelined**: a bounded producer pool (size =
``num_workers``, also tuned live through the config file) runs
``read_batch`` in the background so batch k+1 is being fetched while
batch k is consumed.  Batches are yielded strictly in the serial
order; ``DLROVER_TPU_INPUT_PIPELINE=0`` (or ``pipeline=False``) is
the byte-identical serial fallback.  ``state_dict`` always reports
the sampler position of the last batch actually *yielded* — the
loader's own producer read-ahead can never over-advance a mid-epoch
checkpoint.  Batches the CONSUMER buffers after the yield (e.g.
``device_prefetch``'s in-flight window) are beyond the loader's
horizon: checkpoint at consumed-step boundaries, or accept replaying
up to one prefetch window after a mid-buffer crash — the same
exposure any buffered iterator has.
"""

import collections
import json
import os
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from dlrover_tpu_torch.common.env import input_pipeline_enabled
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.prefetch import _ThroughputMeter, batch_nbytes
from dlrover_tpu_torch.trainer.elastic.sampler import (
    ElasticDistributedSampler,
)

DEFAULT_CONFIG_FILE = "/tmp/dlrover_tpu_paral_config.json"


class ParalConfigTuner:
    """Agent-side: polls master ``ParallelConfig`` and writes the
    config file the dataloader watches (reference ``:30,70``)."""

    def __init__(self, client=None, config_file: str = "",
                 interval: float = 30.0):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        self._client = client or MasterClient.singleton_instance()
        self.config_file = config_file or os.getenv(
            "DLROVER_TPU_PARAL_CONFIG_FILE", DEFAULT_CONFIG_FILE
        )
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _tick(self):
        config = self._client.get_paral_config()
        dataloader = getattr(config, "dataloader", None)
        payload = {
            "version": getattr(config, "version", 0),
            "dataloader": {
                "batch_size": getattr(dataloader, "batch_size", 0),
                "num_workers": getattr(dataloader, "num_workers", 0),
            }
            if dataloader
            else {},
        }
        tmp = self.config_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.config_file)

    def start(self):
        if self._thread is not None:
            return

        def _loop():
            while not self._stopped.wait(self._interval):
                try:
                    self._tick()
                except (ConnectionError, OSError) as e:
                    logger.warning("paral tuner tick failed: %s", e)

        self._thread = threading.Thread(
            target=_loop, name="paral-tuner", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()


class ElasticDataLoader:
    """Batched index loader whose batch size follows the tuned config.

    ``read_batch(indices) -> batch`` turns sampled indices into arrays
    (user-supplied — file reads, tokenization, ...).  Each ``__iter__``
    re-checks the config file; mid-epoch batch-size / num_workers
    changes take effect on the next epoch (matching the reference's
    ``load_config``-on-init + set_batch_size semantics).

    With the pipeline enabled (default; kill-switch
    ``DLROVER_TPU_INPUT_PIPELINE=0``) a producer pool of
    ``num_workers`` threads runs ``read_batch`` up to
    ``prefetch_depth`` batches ahead.  Batches are yielded in exactly
    the serial order, so the pipelined and serial paths are
    byte-identical for a deterministic ``read_batch``.  With
    ``num_workers > 1``, ``read_batch`` must be thread-safe (calls for
    different index batches run concurrently).
    """

    def __init__(
        self,
        dataset_size: int,
        batch_size: int,
        read_batch: Callable[[np.ndarray], object],
        sampler: Optional[ElasticDistributedSampler] = None,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        config_file: str = "",
        drop_last: bool = True,
        num_workers: int = 1,
        prefetch_depth: int = 2,
        pipeline: Optional[bool] = None,
    ):
        self._read_batch = read_batch
        self.batch_size = batch_size
        self.num_workers = max(1, int(num_workers))
        self._prefetch_depth = max(1, int(prefetch_depth))
        self._pipeline = pipeline
        self._config_file = config_file or os.getenv(
            "DLROVER_TPU_PARAL_CONFIG_FILE", DEFAULT_CONFIG_FILE
        )
        self.sampler = sampler or ElasticDistributedSampler(
            dataset_size,
            num_replicas=num_replicas,
            rank=rank,
            shuffle=shuffle,
        )
        self._drop_last = drop_last
        # sampler state of the last batch YIELDED to the consumer —
        # the checkpointable position (the live sampler may have been
        # advanced further by producer read-ahead)
        self._consumed_state: Optional[dict] = None
        self.load_config()

    def _pipeline_on(self) -> bool:
        if self._pipeline is not None:
            return bool(self._pipeline)
        return input_pipeline_enabled()

    def load_config(self):
        if not os.path.exists(self._config_file):
            return
        try:
            with open(self._config_file) as f:
                config = json.load(f)
            dataloader = config.get("dataloader", {})
            new_bs = int(dataloader.get("batch_size", 0))
            if new_bs > 0 and new_bs != self.batch_size:
                logger.info(
                    "dataloader batch size tuned %d -> %d",
                    self.batch_size,
                    new_bs,
                )
                self.batch_size = new_bs
            # the tuner also writes num_workers — apply it to the
            # producer pool (live on the next epoch, like batch_size)
            new_workers = int(dataloader.get("num_workers", 0))
            if new_workers > 0 and new_workers != self.num_workers:
                logger.info(
                    "dataloader num_workers tuned %d -> %d",
                    self.num_workers,
                    new_workers,
                )
                self.num_workers = new_workers
        except (OSError, ValueError) as e:
            logger.warning("paral config read failed: %s", e)

    # ------------------------------------------------------- iteration
    def _index_batches(self):
        """Yield ``(indices, sampler_state_after_draw)`` in the serial
        batch order — the single source of ordering for both paths."""
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield np.asarray(batch), self.sampler.state_dict()
                batch = []
        if batch and not self._drop_last:
            yield np.asarray(batch), self.sampler.state_dict()

    def _iter_serial(self) -> Iterator:
        for indices, watermark in self._index_batches():
            out = self._read_batch(indices)
            self._consumed_state = watermark
            yield out

    def _iter_pipelined(self) -> Iterator:
        from concurrent.futures import ThreadPoolExecutor

        workers = self.num_workers
        depth = max(self._prefetch_depth, workers)
        meter = _ThroughputMeter("read_batch")
        gen = self._index_batches()
        pending = collections.deque()
        pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="input-fetch"
        )

        def _job(indices):
            t0 = time.monotonic()
            out = self._read_batch(indices)
            return out, time.monotonic() - t0

        def _submit_next() -> bool:
            try:
                indices, watermark = next(gen)
            except StopIteration:
                return False
            pending.append((pool.submit(_job, indices), watermark))
            return True

        try:
            for _ in range(depth):
                if not _submit_next():
                    break
            while pending:
                fut, watermark = pending.popleft()
                out, fetch_s = fut.result()
                _submit_next()
                self._consumed_state = watermark
                meter.observe(batch_nbytes(out), fetch_s)
                yield out
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator:
        self.load_config()
        if self._pipeline_on():
            return self._iter_pipelined()
        return self._iter_serial()

    def __len__(self) -> int:
        n = len(self.sampler)
        if self._drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def state_dict(self) -> dict:
        sampler_state = (
            dict(self._consumed_state)
            if self._consumed_state is not None
            else self.sampler.state_dict()
        )
        return {"sampler": sampler_state,
                "batch_size": self.batch_size}

    def load_state_dict(self, state: dict):
        self.sampler.load_state_dict(state.get("sampler", {}))
        self._consumed_state = None
        bs = int(state.get("batch_size", 0))
        if bs > 0:
            self.batch_size = bs
