"""The training loop over ``auto_accelerate``'s train step, on one
device.

Port of ``dlrover_tpu/trainer/trainer.py`` (``TrainingArgs`` :36-80,
``Trainer`` :83, the serial restore ``_init_or_restore_state`` :255-305,
``_resolve_snapshot_mode`` :315-349, ``_maybe_checkpoint`` :361-411,
``_consume_metrics`` :413-433, ``evaluate`` :565-618, ``train``
:619-860) without what later slices bring: the elastic restart path
(``replay_dir``, the prefetch/compile overlap and the drain handler:
ROADMAP A3b), the resident profiler, the metrics exporter and sparse
tables (``trace_interval``, ``metrics_port``, ``sparse_tables``: A7).
Setting one of those raises ``NotImplementedError`` rather than doing
nothing.

Flash checkpoint (``checkpoint_dir``): on start the state is restored
from the newest step the engine finds (shared memory first, then disk)
and training continues from it; every ``save_memory_interval`` steps
the state is snapshotted into shared memory, every
``save_storage_interval`` steps also persisted as ``.drckpt`` shards,
and ``train()`` ends with a persist of the final step.  That persist
is skipped when ``train_step`` itself raised: the optimizer writes the
state in place, so a step cut part-way leaves a state that is neither
the last step's nor the next one's; the exception propagates and the
newest checkpoint stays the last whole step's.  PyTorch updates
the state in place, so a snapshot must not read tensors a later step
writes: "copy" copies the state on the card (on the compute stream,
before the next step is queued) into buffers allocated beside the state
when training starts, and drains them to host memory on a copy stream
while training goes on; "staged" waits until the state is in host
memory (no extra device memory).  "auto" takes "copy" when
twice the state fits in 80 % of the card's memory.  Each call's host
time is kept in ``save_times``; a call that finds the last drain still
running skips its snapshot (``"saved": False``), as the reference does.

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
    "replay_dir": "A3b (elastic restart and replay)",
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
    checkpoint_dir: str = ""
    save_memory_interval: int = 10  # steps between shm snapshots
    save_storage_interval: int = 100  # steps between persisted ckpts
    # "copy" (a second copy of the state on the card, drained in the
    # background), "staged" (the step waits for the copy to host
    # memory) or "auto" (see _resolve_snapshot_mode)
    snapshot_mode: str = "auto"
    # not ported yet: setting any of these raises (see _LATER)
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
        # {"step", "mode", "storage", "saved", "host_s"} per call
        self.save_times = []
        self._engine = None
        self._layouts = None
        self._snapshot_mode = None
        self._snap = None  # "copy": the buffers a snapshot is copied into
        self._storage_step = None  # last step handed to the persist
        if args.checkpoint_dir:
            if args.snapshot_mode not in ("auto", "copy", "staged"):
                raise ValueError(
                    f"snapshot_mode {args.snapshot_mode!r}: auto, copy or "
                    "staged")
            from dlrover_tpu_torch.common import env
            from dlrover_tpu_torch.trainer.checkpoint.engine import (
                CheckpointEngine,
            )

            self._engine = CheckpointEngine(
                checkpoint_dir=args.checkpoint_dir,
                process_rank=env.get_process_rank(),
                process_count=env.get_process_count(),
                node_rank=env.get_node_rank(),
                local_shard_num=env.get_local_process_count(),
            )

    @property
    def checkpoint_engine(self):
        """The flash-checkpoint engine (None without ``checkpoint_dir``);
        its ``io_log`` holds the drains and the restore of this run."""
        return self._engine

    def _init_state(self) -> int:
        if self.state is None:
            self._init_or_restore_state()
        return self.state["step"]

    # ------------------------------------------------------------ resume
    def _init_or_restore_state(self) -> int:
        """Initialise the state, then overwrite it with the newest
        checkpoint the engine agrees on (the serial ``engine.load``),
        and fault in the shared memory of the snapshots to come."""
        self.state = self._fns.init_state(self._rng_seed)
        if self._engine is None:
            return 0
        from dlrover_tpu_torch.trainer.checkpoint.reshard import (
            derive_layouts,
        )

        self._layouts = derive_layouts(self.state)
        step, restored = self._engine.load(
            target=self.state, layouts=self._layouts)
        if step >= 0 and restored is not None:
            logger.info("resumed training from step %d", step)
        self._engine.preallocate_like(self.state)
        self._snapshot_mode = self._resolve_snapshot_mode()
        logger.info("snapshot mode: %s", self._snapshot_mode)
        if self._snapshot_mode == "copy":
            # before the first step, so that the steps' activations are
            # cached around them: made at a snapshot, they would take
            # the blocks the next step's activations were cached in
            self._snap = self._snapshot_buffers()
        return self.state["step"]

    # ------------------------------------------------------------- save
    def _state_bytes(self) -> int:
        from dlrover_tpu_torch.agent.ckpt_shm import _flatten_keyed

        return sum(int(v.nbytes) for _, v in _flatten_keyed(self.state)
                   if torch.is_tensor(v))

    def _resolve_snapshot_mode(self) -> str:
        """"copy" when a second copy of the state fits comfortably on
        the card, "staged" otherwise (a second copy near capacity would
        run the card out of memory; staging trades a blocked step for
        bounded memory).  On the CPU "auto" is "copy"."""
        mode = self._args.snapshot_mode
        if mode != "auto":
            return mode
        dev = self._fns.device
        if dev.type != "cuda":
            return "copy"
        total = torch.cuda.get_device_properties(dev).total_memory
        return "copy" if 2 * self._state_bytes() <= 0.8 * total else "staged"

    def _maybe_checkpoint(self, step: int):
        if self._engine is None:
            return
        to_storage = step % self._args.save_storage_interval == 0
        to_memory = step % self._args.save_memory_interval == 0
        if not (to_storage or to_memory):
            return
        t0 = time.perf_counter()
        # "staged" hands over the live tensors and blocks until they are
        # in shm; "copy" hands over copies made on the compute stream
        # now, which no later step writes, and returns at once
        blocking = self._snapshot_mode == "staged"
        saved = False
        if blocking:
            snap = self.state
        elif not self._engine._snapshot_slot_free(step):
            snap = None  # the last drain still reads the buffers: a skip
        else:
            snap = self._copy_to_snapshot()
        if snap is not None and to_storage:
            saved = self._engine.save_to_storage(
                step, snap, blocking=blocking, layouts=self._layouts)
            if saved:
                self._storage_step = step
        elif snap is not None:
            saved = self._engine.save_to_memory(
                step, snap, blocking=blocking, layouts=self._layouts)
        self.save_times.append({
            "step": step, "mode": self._snapshot_mode,
            "storage": to_storage, "saved": saved,
            "host_s": time.perf_counter() - t0})

    def _snapshot_buffers(self):
        from dlrover_tpu_torch.agent.ckpt_shm import _flatten_keyed

        return [torch.empty_like(v) for _, v in _flatten_keyed(self.state)
                if torch.is_tensor(v)]

    def _copy_to_snapshot(self):
        """The state's keyed leaves, its tensors copied into the snapshot
        buffers on the compute stream (a snapshot is skipped while the
        last one drains, so no copy overwrites a buffer being read)."""
        from dlrover_tpu_torch.agent.ckpt_shm import _flatten_keyed

        pairs = _flatten_keyed(self.state)
        with torch.no_grad():
            torch._foreach_copy_(
                self._snap, [v for _, v in pairs if torch.is_tensor(v)])
        bufs = iter(self._snap)
        return [(k, next(bufs) if torch.is_tensor(v) else v)
                for k, v in pairs]

    def _final_checkpoint(self, step: Optional[int]):
        """Persist the final step (unless the last in-loop save already
        handed exactly this step to the persist), wait for it, close.
        With ``step`` None (the state may be torn) only let a running
        drain (of the snapshot buffers, or of an earlier whole state)
        finish, and close."""
        try:
            drained = self._engine.wait_for_snapshot(timeout=600)
            if step is None:
                return
            saved = drained and self._storage_step == step
            if not saved:
                saved = self._engine.save_to_storage(
                    step, self.state, layouts=self._layouts)
            if saved and not self._engine.wait_for_persist(
                    step, timeout=600):
                logger.error("step %d was not persisted in 600 s", step)
        finally:
            self._engine.close()
            self._snap = None  # a drain still running holds its own refs

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
        # False while train_step runs: it updates the state in place, so
        # an exception there leaves a state no checkpoint may hold
        whole = True
        self._mark_start()
        try:
            while step < self._args.max_steps:
                for batch in self._data_iter_fn():
                    if step >= self._args.max_steps:
                        break
                    batch = batch_to_device(batch, self._fns.device)
                    whole = False
                    self.state, metrics = self._fns.train_step(
                        self.state, batch)
                    whole = True
                    step += 1
                    if pending is not None:
                        step_times.append(self._consume_metrics(*pending))
                    pending = (step, metrics)
                    self._maybe_checkpoint(step)
                    if eval_every and step % eval_every == 0:
                        # settle the pending read so the eval pause is
                        # not booked as a step time
                        step_times.append(self._consume_metrics(*pending))
                        pending = None
                        self.evaluate()
                        self._mark_start()
                else:
                    continue
                break
            if pending is not None:
                step_times.append(self._consume_metrics(*pending))
        except BaseException:
            if self._engine is not None:
                try:
                    self._final_checkpoint(step if whole else None)
                except Exception:  # noqa: BLE001 - the first error wins
                    logger.exception("final checkpoint after a failure")
            raise
        if self._engine is not None:
            self._final_checkpoint(step)
        return {
            "final_step": step,
            "mean_step_time": (
                sum(step_times) / len(step_times) if step_times else 0.0
            ),
        }
