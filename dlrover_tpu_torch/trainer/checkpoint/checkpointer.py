"""User-facing flash-checkpoint API.

Copy of ``dlrover_tpu/trainer/checkpoint/checkpointer.py`` over the
port's engine.  One ``Checkpointer`` covers the port's train state
(``{"step", "params", "opt_state"}``) or any nested dict of tensors:
each process snapshots what it holds.
"""

import os
from enum import Enum
from typing import Optional

from dlrover_tpu_torch.common.env import (
    get_local_process_count,
    get_node_rank,
    get_process_count,
    get_process_rank,
)
from dlrover_tpu_torch.common.storage import is_remote_url
from dlrover_tpu_torch.trainer.checkpoint.engine import CheckpointEngine


class StorageType(Enum):
    MEMORY = 0
    DISK = 1


class Checkpointer:
    """Flash checkpointer for a train state or a nested dict of
    tensors.

    - ``save_checkpoint(step, state, StorageType.MEMORY)``: pause only
      for the device->host shm copy; survives process crashes/restarts.
    - ``save_checkpoint(step, state, StorageType.DISK)``: same pause,
      then the agent persists asynchronously with a two-phase commit.
    - ``load_checkpoint(target)``: newest of shm/disk, copied into
      ``target``.
    """

    def __init__(
        self,
        checkpoint_dir: str,
        process_rank: Optional[int] = None,
        process_count: Optional[int] = None,
        node_rank: Optional[int] = None,
        local_shard_num: Optional[int] = None,
        name: str = "default",
        storage=None,
    ):
        self.checkpoint_dir = checkpoint_dir
        if not is_remote_url(checkpoint_dir):  # URLs need no local dir
            os.makedirs(checkpoint_dir, exist_ok=True)
        rank = get_process_rank() if process_rank is None else process_rank
        world = (
            get_process_count() if process_count is None else process_count
        )
        node = get_node_rank() if node_rank is None else node_rank
        local = (
            get_local_process_count()
            if local_shard_num is None
            else local_shard_num
        )
        self._engine = CheckpointEngine(
            checkpoint_dir,
            process_rank=rank,
            process_count=world,
            node_rank=node,
            local_shard_num=local,
            name=name,
            storage=storage,
        )

    def save_checkpoint(self, step: int, state,
                        storage_type: StorageType = StorageType.DISK) -> bool:
        if storage_type == StorageType.MEMORY:
            return self._engine.save_to_memory(step, state)
        return self._engine.save_to_storage(step, state)

    def load_checkpoint(self, target=None):
        """Returns (step, state); (-1, None) when no checkpoint exists."""
        return self._engine.load(target)

    def latest_persisted_step(self) -> int:
        return self._engine.latest_persisted_step()

    def wait_latest_checkpoint(self, step: int, timeout: float = 120) -> bool:
        return self._engine.wait_for_persist(step, timeout)

    def close(self):
        self._engine.close()
