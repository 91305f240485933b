"""Step-level elasticity: global-batch-invariant accumulation + progress.

Reference parity: ``dlrover/trainer/torch/elastic/trainer.py:181``
(``ElasticTrainer``) and ``GradientState:53`` — gradient accumulation is
re-derived from the *current* world size so the effective global batch
stays constant as nodes join/leave; the step counter is reported to the
master's SpeedMonitor.

Port of ``dlrover_tpu/trainer/elastic/trainer.py``: the trainer
exposes ``num_micro_steps`` and ``accumulate_gradients``, an eager sum
over micro-batches whose grads are tensors (or dicts, lists and tuples
of them).  Progress reporting goes straight to the master over gRPC
from rank 0 and to a step file the agent's ``TrainingMonitor`` watches
(``DLROVER_TPU_STEP_FILE``, which the agent sets per job; with none set,
no step file is written: the JAX version's default of one path a
machine has no reader outside an agent).  Each rank on a card also
writes the card's memory in use (``torch.cuda``) to
``DLROVER_TPU_CHIP_STATS_FILE`` (a ``.json`` file, or a directory with
one ``rank<r>.json`` a rank), which the agent's ``ResourceMonitor``
reads.
"""

import json
import os
import time
from typing import Callable, Optional

import torch

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.events import (
    anchored_now,
    get_event_logger,
)
from dlrover_tpu_torch.trainer.elastic.context import (
    process_count,
    process_rank,
)

STEP_FILE_ENV = "DLROVER_TPU_STEP_FILE"
CHIP_STATS_ENV = "DLROVER_TPU_CHIP_STATS_FILE"


def _write_json(path: str, data):
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass


def card_stats(device) -> Optional[dict]:
    """The card's memory in use by this process (the caching
    allocator's counters, no synchronisation), or None off the card."""
    if device is None or torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_initialized():
        return None
    dev = torch.device(device)
    return {
        "device": str(dev),
        "name": torch.cuda.get_device_name(dev),
        "memory_allocated_mb": torch.cuda.memory_allocated(dev) >> 20,
        "memory_reserved_mb": torch.cuda.memory_reserved(dev) >> 20,
        "max_memory_allocated_mb":
            torch.cuda.max_memory_allocated(dev) >> 20,
    }


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and of ``rest``, which share
    its structure), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class ElasticTrainer:
    def __init__(
        self,
        global_batch_size: int,
        micro_batch_size: int,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
        report_interval: float = 15.0,
        master_client=None,
        step_file: str = "",
        device=None,
    ):
        """``device``: the card whose memory in use rides the chip-stats
        file (None, or the CPU: no stats)."""
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self.world_size = world_size or process_count()
        self.rank = rank if rank is not None else process_rank()
        per_step = self.micro_batch_size * self.world_size
        if global_batch_size % per_step != 0:
            logger.warning(
                "global batch %d not divisible by micro*world %d; "
                "rounding accumulation up",
                global_batch_size,
                per_step,
            )
        self.num_micro_steps = max(
            1, (global_batch_size + per_step - 1) // per_step
        )
        self.global_step = 0
        self._step_file = step_file or os.getenv(STEP_FILE_ENV, "")
        self._device = device
        self._report_interval = report_interval
        self._last_report = 0.0
        self._client = master_client
        # timeline: each step_done closes a `step` span back to the
        # previous one — the useful-time side of the goodput ledger
        self._events = get_event_logger()
        self._step_mark = None  # (wall, mono) of the last step_done

    # ------------------------------------------------------------ progress
    def _master_client(self):
        if self._client is None and os.getenv(NodeEnv.MASTER_ADDR):
            from dlrover_tpu_torch.agent.master_client import MasterClient

            self._client = MasterClient.singleton_instance()
        return self._client

    def step_done(self, steps: int = 1):
        """Advance the global step; rank 0 reports progress."""
        self.global_step += steps
        if self._events.enabled:
            now_m = time.monotonic()
            now_w = anchored_now(now_m)
            if self._step_mark is not None:
                dur = now_m - self._step_mark[1]
                self._events.complete(
                    "step", now_w - dur, dur, step=self.global_step
                )
            self._step_mark = (now_w, now_m)
        now = time.time()
        if now - self._last_report < self._report_interval:
            return
        self._last_report = now
        self._write_chip_stats(now)
        if self.rank != 0:
            return
        if self._step_file:
            _write_json(self._step_file,
                        {"step": self.global_step, "timestamp": now})
        client = self._master_client()
        if client is not None:
            try:
                client.report_global_step(self.global_step, now)
            except ConnectionError:
                pass

    def restart_step_clock(self):
        """Start the next ``step`` span now (the trainer calls it after
        the ranks' step barrier): what came before it, a wait for a
        slower peer, is not this rank's step time."""
        if self._step_mark is not None:
            now_m = time.monotonic()
            self._step_mark = (anchored_now(now_m), now_m)

    def _write_chip_stats(self, now: float):
        path = os.getenv(CHIP_STATS_ENV, "")
        stats = card_stats(self._device) if path else None
        if stats is None:
            return
        stats.update(rank=self.rank, step=self.global_step, timestamp=now)
        if not path.endswith(".json"):  # a directory, a file a rank
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, f"rank{self.rank}.json")
        _write_json(path, stats)

    # -------------------------------------------------------- accumulation
    def accumulate_gradients(
        self,
        grad_fn: Callable,
        params,
        micro_batches,
    ):
        """Eager accumulation over ``micro_batches``: ``grad_fn(params,
        batch)`` returns ``(loss, grads)``, grads a tensor or a dict,
        list or tuple of them; returns (mean_loss, mean_grads)."""
        total_loss = None
        total_grads = None
        count = 0
        for batch in micro_batches:
            loss, grads = grad_fn(params, batch)
            if total_grads is None:
                total_loss, total_grads = loss, grads
            else:
                total_loss = total_loss + loss
                total_grads = _tree_map(
                    lambda a, b: a + b, total_grads, grads
                )
            count += 1
        scale = 1.0 / max(count, 1)
        mean_grads = _tree_map(lambda g: g * scale, total_grads)
        return total_loss * scale, mean_grads

    def state_dict(self) -> dict:
        return {"global_step": self.global_step}

    def load_state_dict(self, state: dict):
        self.global_step = int(state.get("global_step", 0))
