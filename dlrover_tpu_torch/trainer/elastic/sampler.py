"""Checkpointable elastic sampler — resumes mid-epoch after re-mesh.

Copy of ``dlrover_tpu/trainer/elastic/sampler.py``.

Reference parity: ``dlrover/trainer/torch/elastic/sampler.py:25``
(``ElasticDistributedSampler``: state_dict ``:118`` / load_state_dict
``:130`` keep the consumed-sample offset so a job that restarts with a
different world size continues from the same global position).

Framework-agnostic: works over any sized dataset (only ``len`` is
needed) and yields integer indices, so it feeds numpy/grain/torch
loaders alike.
"""

from typing import Iterator, Optional

import numpy as np


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas"
            )
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # samples of *this epoch* already consumed across ALL replicas
        self.completed_num = 0
        if drop_last:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = (
                dataset_size + num_replicas - 1
            ) // num_replicas
        self.total_size = self.num_samples * num_replicas

    # ------------------------------------------------------------ protocol
    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed_num = 0

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                indices = np.concatenate([indices, indices[:pad]])
        return indices[: self.total_size]

    def __iter__(self) -> Iterator[int]:
        indices = self._global_indices()
        # skip what the previous incarnation already consumed, then
        # stride by the *current* replica count — the remaining work is
        # redistributed evenly over the new world
        start = self.completed_num + self.rank
        for idx in indices[start :: self.num_replicas]:
            self.completed_num += self.num_replicas
            yield int(idx)

    def __len__(self) -> int:
        remaining = self.total_size - self.completed_num
        return max(0, remaining // self.num_replicas)

    # ---------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "completed_num": self.completed_num,
        }

    def load_state_dict(self, state: dict):
        self.epoch = int(state.get("epoch", 0))
        completed = int(state.get("completed_num", 0))
        # align to the new replica stride so every rank starts from the
        # same global offset
        completed -= completed % self.num_replicas
        self.completed_num = completed


class ElasticBatchIterator:
    """Batches an ``ElasticDistributedSampler`` into index arrays; the
    per-step granularity the checkpoint engine snapshots."""

    def __init__(
        self,
        sampler: ElasticDistributedSampler,
        batch_size: int,
        drop_last: bool = True,
    ):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield np.asarray(batch)
                batch = []
        if batch and not self.drop_last:
            yield np.asarray(batch)

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def state_dict_with_sampler(
    state: dict, sampler: Optional[ElasticDistributedSampler]
) -> dict:
    """Attach dataset position to a checkpoint state dict (reference
    checkpoints the sampler alongside the model — SURVEY.md §5.4)."""
    if sampler is not None:
        state = dict(state)
        state["_sampler"] = sampler.state_dict()
    return state


def restore_sampler_from_state(
    state: dict, sampler: Optional[ElasticDistributedSampler]
):
    if sampler is not None and isinstance(state, dict) and "_sampler" in state:
        sampler.load_state_dict(state["_sampler"])
