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
from rank 0; the JAX version's step file, which only the agent's
``TrainingMonitor`` reads, comes with that monitor (ROADMAP A3c).
"""

import os
import time
from typing import Callable, Optional

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
    ):
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
        if self.rank != 0:
            return
        now = time.time()
        if now - self._last_report < self._report_interval:
            return
        self._last_report = now
        client = self._master_client()
        if client is not None:
            try:
                client.report_global_step(self.global_step, now)
            except ConnectionError:
                pass

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
