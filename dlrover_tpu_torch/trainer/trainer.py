"""The training loop over ``auto_accelerate``'s train step, on one
device.

Port of ``dlrover_tpu/trainer/trainer.py`` (``TrainingArgs`` :36-80,
``Trainer`` :83, ``_consume_metrics`` :413-433, ``evaluate`` :565-618,
``train`` :619-860) without what later slices bring: flash checkpoint
and the elastic restart path (``checkpoint_dir``, ``replay_dir``:
ROADMAP A3), the resident profiler, the metrics exporter and sparse
tables (``trace_interval``, ``metrics_port``, ``sparse_tables``: A7).
Setting one of those raises ``NotImplementedError`` rather than doing
nothing.

``train()`` keeps the reference's one-step-delayed metric read: step N's
metrics are read (which waits for step N's end on the card, its
``done`` event) only after step N+1 has been queued.  How far the host
gets ahead is not the loop's to choose: ``train_step`` returns once the
card's launch queue has taken its last kernel, and a 7B-width step
launches more kernels than the queue holds (PERF.md), so step N+1 is
nearly done by then.  Host-clock gaps between reads are therefore not
step times.  Step times run from one step's end to the next on the
card's own clock: the time between consecutive ``done`` events (the
first from an event recorded as ``train()`` starts).  On the CPU, where
a step is synchronous, they are host-clock gaps between reads.  Each
read appends ``{"step", "loss", "grad_norm", "step_time_s"}`` to
``history``.
"""

import logging
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch

from dlrover_tpu_torch.parallel.train_step import batch_to_device

logger = logging.getLogger(__name__)

# option -> the ROADMAP slice that brings it
_LATER = {
    "checkpoint_dir": "A3 (flash checkpoint)",
    "replay_dir": "A3 (elastic restart and replay)",
    "trace_interval": "A7 (device-side observability)",
    "metrics_port": "A7 (device-side observability)",
    "sparse_tables": "A7 (sparse tables)",
}


@dataclass
class TrainingArgs:
    max_steps: int
    log_interval: int = 10
    # periodic in-train evaluation (steps; 0 = off), needs eval_iter_fn
    eval_interval: int = 0
    # max batches per evaluation pass (0 = drain the eval iterator)
    eval_max_batches: int = 0
    # not ported yet: setting any of these raises (see _LATER)
    checkpoint_dir: str = ""
    replay_dir: str = ""
    trace_interval: int = 0
    metrics_port: int = 0
    sparse_tables: Optional[dict] = None


class Trainer:
    def __init__(
        self,
        accelerate_result,
        args: TrainingArgs,
        data_iter_fn: Callable[[], Iterable],
        eval_iter_fn: Optional[Callable[[], Iterable]] = None,
        rng_seed: int = 0,
    ):
        """``data_iter_fn()`` returns a fresh iterator of host batches
        (dicts of numpy arrays or tensors); ``eval_iter_fn`` enables
        ``evaluate()`` and the ``eval_interval`` cadence."""
        for name, slice_ in _LATER.items():
            if getattr(args, name):
                raise NotImplementedError(
                    f"TrainingArgs.{name} is not ported yet: ROADMAP "
                    f"{slice_}"
                )
        self._result = accelerate_result
        self._fns = accelerate_result.fns
        self._args = args
        self._data_iter_fn = data_iter_fn
        self._eval_iter_fn = eval_iter_fn
        self._rng_seed = rng_seed
        self.state = None
        self.history = []
        self._last_done = None  # a CUDA event or a host time

    def _init_state(self) -> int:
        if self.state is None:
            self.state = self._fns.init_state(self._rng_seed)
        return self.state["step"]

    def _mark_start(self):
        """Where the next step's time starts: now, on the card's clock
        (an event queued behind all earlier work) or the host's."""
        if self._fns.device.type == "cuda":
            self._last_done = torch.cuda.Event(enable_timing=True)
            self._last_done.record()
        else:
            self._last_done = time.perf_counter()

    def _consume_metrics(self, step: int, metrics) -> float:
        done = metrics.get("done")
        if done is not None:
            done.synchronize()  # the whole step, optimizer included
            dt = self._last_done.elapsed_time(done) / 1e3
            self._last_done = done
        else:
            now = time.perf_counter()
            dt = now - self._last_done
            self._last_done = now
        loss = float(metrics["loss"])
        record = {"step": step, "loss": loss, "step_time_s": dt}
        if "grad_norm" in metrics:
            record["grad_norm"] = float(metrics["grad_norm"])
        self.history.append(record)
        if self._args.log_interval and step % self._args.log_interval == 0:
            logger.info("step %d loss %.4f (%.3fs/step)", step, loss, dt)
        return dt

    def evaluate(self, eval_iter_fn=None, max_batches: int = 0):
        """Mean forward loss over the eval iterator (``eval_step``, no
        grad).  Returns ``{"eval_loss", "eval_batches",
        "eval_time_s"}``."""
        it_fn = eval_iter_fn or self._eval_iter_fn
        if it_fn is None:
            raise ValueError(
                "evaluate() needs eval_iter_fn (ctor or argument)"
            )
        self._init_state()
        max_batches = max_batches or self._args.eval_max_batches
        t0 = time.perf_counter()
        total, count, pending = 0.0, 0, None
        for batch in it_fn():
            if max_batches and count >= max_batches:
                break
            metrics = self._fns.eval_step(
                self.state, batch_to_device(batch, self._fns.device))
            if pending is not None:
                total += float(pending["loss"])
            pending = metrics
            count += 1
        if pending is not None:
            total += float(pending["loss"])
        if count == 0:
            raise ValueError("eval iterator yielded no batches")
        result = {
            "eval_loss": total / count,
            "eval_batches": count,
            "eval_time_s": round(time.perf_counter() - t0, 3),
        }
        logger.info("eval @ step %d: loss %.4f (%d batches, %.2fs)",
                    self.state["step"], result["eval_loss"], count,
                    result["eval_time_s"])
        return result

    def train(self):
        step = self._init_state()
        step_times = []
        eval_every = (
            self._args.eval_interval if self._eval_iter_fn is not None
            else 0
        )
        pending = None  # (step, metrics) read one step late
        self._mark_start()
        while step < self._args.max_steps:
            for batch in self._data_iter_fn():
                if step >= self._args.max_steps:
                    break
                self.state, metrics = self._fns.train_step(
                    self.state, batch_to_device(batch, self._fns.device))
                step += 1
                if pending is not None:
                    step_times.append(self._consume_metrics(*pending))
                pending = (step, metrics)
                if eval_every and step % eval_every == 0:
                    # settle the pending read so the eval pause is not
                    # booked as a step time
                    step_times.append(self._consume_metrics(*pending))
                    pending = None
                    self.evaluate()
                    self._mark_start()
            else:
                continue
            break
        if pending is not None:
            step_times.append(self._consume_metrics(*pending))
        return {
            "final_step": step,
            "mean_step_time": (
                sum(step_times) / len(step_times) if step_times else 0.0
            ),
        }
