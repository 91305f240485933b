"""Trainer callback protocol.

Copy of ``dlrover_tpu/trainer/callbacks.py`` (imports rewritten).  The
port's ``Trainer`` fires ``on_train_begin``, ``on_step_end`` (when it
reads a step's metrics), ``on_save``, ``on_eval`` and ``on_train_end``
at the reference's points; it attaches no ``MetricsCallback`` of its
own (that comes with the metrics exporter, ROADMAP A7).

Reference parity: ``atorch/atorch/trainer/atorch_trainer.py:216``
(HF ``TrainerCallback`` integration: ``CallbackHandler`` dispatching
``on_step_end`` / ``on_evaluate`` / ``on_save`` / ``on_log`` to user
callbacks, TensorBoard among them).  The redesign keeps the same
seam — observers of the training loop — but passes plain dicts (step,
metrics) instead of the reference's TrainerControl mutation protocol:
flow control (stop/resume/scale) belongs to the elastic agent and the
master, not to in-process callbacks.

Built-ins:
- ``MetricsCallback``    -> gauges on a MetricsRegistry (Prometheus
                            via the C++ exporter)
- ``JsonlLoggerCallback`` -> append-only train/eval curves on disk
"""

import json
import os
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class TrainerCallback:
    """Base class; override any subset.  All hooks receive plain
    data — callbacks observe, they do not steer."""

    def on_train_begin(self, start_step: int):
        ...

    def on_step_end(self, step: int, metrics: Dict):
        """After every optimizer step.  ``metrics``: loss, grad_norm,
        step_time_s, lr (when the trainer knows the schedule)."""

    def on_eval(self, step: int, metrics: Dict):
        """After each evaluation pass (``evaluate()`` or the periodic
        in-train cadence).  ``metrics``: eval_loss, eval_batches,
        eval_time_s."""

    def on_save(self, step: int, storage: bool):
        """After a checkpoint snapshot is handed off (``storage``:
        persisted tier vs memory-only)."""

    def on_train_end(self, summary: Dict):
        ...


class CallbackList(TrainerCallback):
    """Fan-out with isolation: one misbehaving callback must not take
    down the training loop (errors are logged, not raised)."""

    def __init__(self, callbacks: Optional[List[TrainerCallback]] = None):
        self.callbacks = list(callbacks or [])

    def _fire(self, hook: str, *args):
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception as e:  # noqa: BLE001
                logger.error(
                    "callback %s.%s failed: %s",
                    type(cb).__name__, hook, e,
                )

    def on_train_begin(self, start_step):
        self._fire("on_train_begin", start_step)

    def on_step_end(self, step, metrics):
        self._fire("on_step_end", step, metrics)

    def on_eval(self, step, metrics):
        self._fire("on_eval", step, metrics)

    def on_save(self, step, storage):
        self._fire("on_save", step, storage)

    def on_train_end(self, summary):
        self._fire("on_train_end", summary)


class MetricsCallback(TrainerCallback):
    """Mirror train/eval metrics onto a MetricsRegistry (the exporter
    serves them as Prometheus gauges)."""

    def __init__(self, registry):
        self._registry = registry

    def on_step_end(self, step, metrics):
        self._registry.set_gauge("train_step", step)
        if "loss" in metrics:
            self._registry.set_gauge("train_loss", metrics["loss"])
        if "lr" in metrics:
            self._registry.set_gauge("learning_rate", metrics["lr"])
        if "step_time_s" in metrics:
            self._registry.observe_duration(
                "step_time", metrics["step_time_s"]
            )

    def on_eval(self, step, metrics):
        if "eval_loss" in metrics:
            self._registry.set_gauge("eval_loss", metrics["eval_loss"])

    def on_save(self, step, storage):
        self._registry.set_gauge("last_checkpoint_step", step)


class JsonlLoggerCallback(TrainerCallback):
    """Append train/eval curves to ``<dir>/train_log.jsonl`` — the
    flat-file analog of the reference's TensorBoard callback (plot
    with any tool; rank-0-only by construction: give each rank its
    own dir or attach the callback on rank 0)."""

    def __init__(self, log_dir: str, train_every: int = 1):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "train_log.jsonl")
        self._train_every = max(train_every, 1)

    def _append(self, record: Dict):
        with open(self._path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def on_step_end(self, step, metrics):
        if step % self._train_every:
            return
        self._append(
            {"kind": "train", "step": step, "t": time.time(), **metrics}
        )

    def on_eval(self, step, metrics):
        self._append(
            {"kind": "eval", "step": step, "t": time.time(), **metrics}
        )

    def on_train_end(self, summary):
        self._append({"kind": "end", "t": time.time(), **summary})


class TensorBoardCallback(TrainerCallback):
    """Write train/eval curves as TensorBoard event files.

    Reference parity: ``atorch/atorch/trainer/atorch_trainer.py:216``
    integrates TensorBoard into the trainer loop; the trainer
    reaches the same surface through torch's bundled SummaryWriter
    (it needs the ``tensorboard`` package beside torch).  Rank-0-only
    by construction: attach the callback on rank 0 or give each rank
    its own log dir.  Raises
    ImportError at CONSTRUCTION when no writer implementation exists,
    so a misconfigured job fails loudly instead of silently logging
    nothing.
    """

    def __init__(self, log_dir: str, train_every: int = 1):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=log_dir)
        self._train_every = max(train_every, 1)

    def _scalars(self, prefix: str, step: int, metrics: Dict):
        for key, value in metrics.items():
            if isinstance(value, (int, float)):
                self._writer.add_scalar(
                    f"{prefix}/{key}", value, global_step=step
                )

    def on_step_end(self, step, metrics):
        if step % self._train_every:
            return
        self._scalars("train", step, metrics)

    def on_eval(self, step, metrics):
        self._scalars("eval", step, metrics)

    def on_save(self, step, storage):
        self._writer.add_scalar(
            "checkpoint/persisted" if storage else "checkpoint/memory",
            1.0,
            global_step=step,
        )

    def on_train_end(self, summary):
        self._scalars("summary", summary.get("final_step", 0), summary)
        self._writer.flush()
        self._writer.close()
