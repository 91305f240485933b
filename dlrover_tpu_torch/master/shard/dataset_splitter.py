"""Dataset splitters: partition a dataset into shards the master hands
out to workers.

Copy of ``dlrover_tpu/master/shard/dataset_splitter.py``.

Reference parity: ``dlrover/python/master/shard/dataset_splitter.py:90,
144,257,359`` (DatasetSplitter ABC, Table/Text/Streaming splitters).
Shards are index ranges — the TPU data path feeds them to per-host input
pipelines; with dynamic shape-stable batches the shard boundary never
leaks into jit-land.
"""

import json
import random
from abc import ABCMeta, abstractmethod
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import DataShard


class PartitionOffsets:
    """Unconsumed sample offsets of a streaming dataset."""

    def __init__(self, partition_offsets: Optional[dict] = None):
        self.partition_offsets = partition_offsets or {}


class DatasetSplitter(metaclass=ABCMeta):
    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self.num_epochs = num_epochs
        self.epoch = 0

    @abstractmethod
    def create_shards(self):
        ...

    @abstractmethod
    def get_shards(self) -> List[DataShard]:
        ...

    @abstractmethod
    def checkpoint(self) -> str:
        ...

    @abstractmethod
    def restore_checkpoint(self, checkpoint: str):
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous index-range shards of a table-like dataset; optional
    epoch-level shuffle of shard order (reference ``:144``)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        max_shard_count: int = 50000,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._max_shard_count = max_shard_count
        self._subepoch_num_per_epoch = 0
        self._shards: List[DataShard] = []
        self._subepoch_idx = 0

    def get_shards(self) -> List[DataShard]:
        return self._shards

    def create_shards(self):
        logger.info(
            "create shards for dataset %s size=%s shard_size=%s epoch=%s",
            self.dataset_name,
            self.dataset_size,
            self.shard_size,
            self.epoch,
        )
        shard_count = (
            self.dataset_size + self.shard_size - 1
        ) // self.shard_size
        if shard_count <= self._max_shard_count:
            if not self._shards:
                self.epoch += 1
                self._shards = self._create_shards_with_range(
                    0, self.dataset_size
                )
            else:
                self.epoch += 1
                if self._shuffle:
                    random.shuffle(self._shards)
        else:
            # split an epoch into sub-epochs to bound the in-memory
            # shard table (reference ``:201``)
            if self._subepoch_num_per_epoch == 0:
                self._subepoch_num_per_epoch = (
                    shard_count + self._max_shard_count - 1
                ) // self._max_shard_count
            if self._subepoch_idx % self._subepoch_num_per_epoch == 0:
                self.epoch += 1
            subepoch_size = self._max_shard_count * self.shard_size
            start = (
                self._subepoch_idx % self._subepoch_num_per_epoch
            ) * subepoch_size
            end = min(start + subepoch_size, self.dataset_size)
            self._subepoch_idx += 1
            self._shards = self._create_shards_with_range(start, end)

    def _create_shards_with_range(self, start: int, end: int):
        shards = []
        for lo in range(start, end, self.shard_size):
            hi = min(lo + self.shard_size, end)
            shards.append(DataShard(self.dataset_name, lo, hi))
        if self._shuffle:
            random.shuffle(shards)
        return shards

    def checkpoint(self) -> str:
        return json.dumps(
            {
                "epoch": self.epoch,
                "subepoch_idx": self._subepoch_idx,
                "shards": [[s.start, s.end] for s in self._shards],
            }
        )

    def restore_checkpoint(self, checkpoint: str):
        state = json.loads(checkpoint)
        self.epoch = state["epoch"]
        self._subepoch_idx = state.get("subepoch_idx", 0)
        self._shards = [
            DataShard(self.dataset_name, lo, hi)
            for lo, hi in state["shards"]
        ]


class TextDatasetSplitter(DatasetSplitter):
    """Shards carrying explicit (optionally shuffled) per-record indices
    of a text file (reference ``:257``)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._shards: List[DataShard] = []

    def get_shards(self) -> List[DataShard]:
        return self._shards

    def create_shards(self):
        self.epoch += 1
        indices = list(range(self.dataset_size))
        if self._shuffle:
            random.shuffle(indices)
        shards = []
        for lo in range(0, self.dataset_size, self.shard_size):
            hi = min(lo + self.shard_size, self.dataset_size)
            shards.append(
                DataShard(
                    self.dataset_name,
                    lo,
                    hi,
                    record_indices=indices[lo:hi],
                )
            )
        self._shards = shards

    def checkpoint(self) -> str:
        return json.dumps(
            {
                "epoch": self.epoch,
                "shards": [
                    [s.start, s.end, s.record_indices] for s in self._shards
                ],
            }
        )

    def restore_checkpoint(self, checkpoint: str):
        state = json.loads(checkpoint)
        self.epoch = state["epoch"]
        self._shards = [
            DataShard(self.dataset_name, lo, hi, record_indices=idx)
            for lo, hi, idx in state["shards"]
        ]


class StreamingDatasetSplitter(DatasetSplitter):
    """Shards over an unbounded stream: consumes a moving window of
    offsets, dataset_size grows as data arrives (reference ``:359``)."""

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        partition_offset: Optional[PartitionOffsets] = None,
        dataset_size: int = -1,
        fetch_data_size: int = 10000,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, 1)
        self._partition_offset = partition_offset or PartitionOffsets()
        self._fetch_data_size = fetch_data_size
        self._shards: List[DataShard] = []

    def get_shards(self) -> List[DataShard]:
        return self._shards

    def epoch_finished(self) -> bool:
        return self.dataset_size == 0

    def create_shards(self):
        shards = []
        if self.dataset_size > 0:
            fetch = min(self.dataset_size, self._fetch_data_size)
            self.dataset_size -= fetch
        else:
            fetch = self._fetch_data_size
        for name, offset in list(
            self._partition_offset.partition_offsets.items()
        ):
            for lo in range(offset, offset + fetch, self.shard_size):
                hi = min(lo + self.shard_size, offset + fetch)
                shards.append(DataShard(str(name), lo, hi))
            self._partition_offset.partition_offsets[name] = offset + fetch
        self._shards = shards

    def checkpoint(self) -> str:
        return json.dumps(
            {
                "epoch": self.epoch,
                "dataset_size": self.dataset_size,
                "partition_offsets": (
                    self._partition_offset.partition_offsets
                ),
                "shards": [[s.name, s.start, s.end] for s in self._shards],
            }
        )

    def restore_checkpoint(self, checkpoint: str):
        state = json.loads(checkpoint)
        self.epoch = state["epoch"]
        self.dataset_size = state["dataset_size"]
        self._partition_offset = PartitionOffsets(
            state["partition_offsets"]
        )
        self._shards = [
            DataShard(name, lo, hi) for name, lo, hi in state["shards"]
        ]


def new_dataset_splitter(
    shuffle: bool,
    shard_size: int,
    dataset_size: int,
    num_epochs: int,
    dataset_name: str,
    storage_type: str = "table",
) -> DatasetSplitter:
    """Factory matching the reference's ``new_dataset_splitter``."""
    if storage_type in ("", "table"):
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "text":
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle
        )
    if storage_type == "stream":
        return StreamingDatasetSplitter(
            dataset_name,
            shard_size,
            # without explicit partitions, consume one default partition
            # from offset 0 so shards actually get produced
            partition_offset=PartitionOffsets({dataset_name: 0}),
            dataset_size=dataset_size,
        )
    raise ValueError(f"unknown dataset storage type {storage_type}")
