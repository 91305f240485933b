"""The training loop over ``auto_accelerate``'s train step, on one card
or data-parallel over a mesh of ``data`` and ``fsdp`` axes, one process
per card.

Port of ``dlrover_tpu/trainer/trainer.py`` (``TrainingArgs`` :36-80,
``Trainer`` :83, the restart overlap :131-166, ``_init_or_restore_state``
:255-305, ``_resolve_snapshot_mode`` :315-349, ``_maybe_checkpoint``
:361-411, ``_consume_metrics`` :413-433, ``evaluate`` :565-618,
``train`` :619-860), with the reference's callbacks (``callbacks``:
``on_train_begin``, ``on_step_end`` when a step's metrics are read,
``on_save``, ``on_eval``, ``on_train_end``; ``trainer/callbacks.py``),
its replay recorder (``replay_dir``: each step's batch recorded before
the step, the state's digest after every ``replay_digest_interval``-th;
``trainer/replay.py``) and its loss-spike capture
(``capture_loss_spikes``), without what a later slice brings: the
resident profiler, the metrics exporter and sparse tables
(``trace_interval``, ``metrics_port``, ``sparse_tables``: ROADMAP A7).
Setting one of those raises ``NotImplementedError`` rather than doing
nothing.

Under the elastic launch (``python -m dlrover_tpu_torch.run``) the
``Trainer`` joins the agent's world (``init_distributed`` on the train
step's device), reports progress to the master through an
``ElasticTrainer`` (``progress``), watches its own steps with a
``HangDetector`` (a worker with no step in ``hang_timeout`` seconds
reports the hang and exits, and the agent restarts it), and with
``checkpoint_dir`` installs the drain handler: after the agent's
SIGUSR1 every step is snapshotted to shared memory, blocking
(``trainer/drain.py``).  At world > 1 the train step is the sharded one
(``parallel/train_step.py``): each rank takes its rows of every global
batch (``BATCH -> (data, fsdp)``), and the gradients are mean-reduced
over the ranks, so that the ranks train one model.  The ranks also meet
at a barrier after every step, on a gloo group of the host loops
(``ElasticContext.host_group``), so that the barrier never waits on the
card and the loop still queues one step ahead of it (``_couple_ranks``).

Batches reach the step through ``data.prefetch.device_prefetch(...,
size=2, sharding=fns.batch_sharding, pipelined=True)``, as in the
reference: the host iterator runs on a background thread, the rank's
rows cross to the card on a copy stream, two batches in flight.  With
``DLROVER_TPU_INPUT_PIPELINE=0`` the fetch is inline (``pipelined=
False``), the same batches in the same order.  ``h2d_times()`` reads
each batch's copy.

Flash checkpoint (``checkpoint_dir``): on start the state is restored
from the newest step the engine finds (shared memory first, then disk)
and training continues from it.  The restore is overlapped, as in the
reference: ``__init__`` starts the engine's restore prefetch
(``trainer/restart_path.py``), which finds what is restorable and opens
the newest shared-memory slot (or streams a checkpoint on disk into
host memory) while ``init_state`` builds the state on the card; the
restore then reads the slot straight onto the card (``finish_restore``).
Staging the slot in host memory beside ``init_state`` was measured to
stretch ``init_state`` by more than it saves (``PERF.md``).  With
``DLROVER_TPU_RESTART_OVERLAP=0``, or when the agent's previous world
(``DLROVER_TPU_PREV_WORLD``) differs from this one, it is the serial
``engine.load``.  Every ``save_memory_interval`` steps
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

import collections
import logging
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch

logger = logging.getLogger(__name__)

# option -> the ROADMAP slice that brings it
_LATER = {
    "trace_interval": "A7 (device-side observability)",
    "metrics_port": "A7 (device-side observability)",
    "sparse_tables": "A7 (sparse tables)",
}


@dataclass
class TrainingArgs:
    max_steps: int
    log_interval: int = 10
    # seconds with no finished step before the worker exits as hung
    hang_timeout: float = 1800.0
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
    # record steps (``spike_<step>.npz`` + ``spikes.jsonl``) whose loss
    # stands out of the recent window, in spike_dir (default:
    # <checkpoint_dir or the temp dir>/spikes)
    capture_loss_spikes: bool = False
    spike_dir: str = ""
    # deterministic-replay flight recorder (trainer/replay.py): batches
    # ring-logged every step under <replay_dir>/rank<r>, state digests
    # every replay_digest_interval steps (a digest copies the whole
    # state to the host: keep the interval coarse; <= 0: batches only)
    replay_dir: str = ""
    replay_digest_interval: int = 50
    # not ported yet: setting any of these raises (see _LATER)
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
        callbacks=None,
    ):
        """``data_iter_fn()`` returns a fresh iterator of host batches
        (dicts of numpy arrays or tensors); ``eval_iter_fn`` enables
        ``evaluate()`` and the ``eval_interval`` cadence; ``callbacks``
        is a list of ``trainer.callbacks.TrainerCallback``."""
        for name, slice_ in _LATER.items():
            if getattr(args, name):
                raise NotImplementedError(
                    f"TrainingArgs.{name} is not ported yet: ROADMAP "
                    f"{slice_}"
                )
        from dlrover_tpu_torch.trainer.callbacks import CallbackList
        from dlrover_tpu_torch.trainer.elastic import (
            ElasticTrainer,
            init_distributed,
        )
        from dlrover_tpu_torch.trainer.fault_tolerance import (
            LossSpikeCapture,
        )

        self._result = accelerate_result
        self._fns = accelerate_result.fns
        self._ctx = init_distributed(self._fns.device)
        # progress reports only: the batch is the caller's, one micro
        # step a rank
        self.progress = ElasticTrainer(
            global_batch_size=self._ctx.world_size, micro_batch_size=1,
            world_size=self._ctx.world_size, rank=self._ctx.rank,
            device=self._fns.device)
        self._args = args
        self._data_iter_fn = data_iter_fn
        self._eval_iter_fn = eval_iter_fn
        self._rng_seed = rng_seed
        self._callbacks = CallbackList(callbacks)
        self._replay = None
        if args.replay_dir:
            from dlrover_tpu_torch.trainer.replay import ReplayRecorder

            self._replay = ReplayRecorder(os.path.join(
                args.replay_dir, f"rank{self._ctx.rank:05d}"))
        self._spikes = (
            LossSpikeCapture(
                args.spike_dir or os.path.join(
                    args.checkpoint_dir or tempfile.gettempdir(), "spikes"))
            if args.capture_loss_spikes else None
        )
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
        #: host wall-clock times (``time.time()``) of the legs a
        #: (re)start runs through: "state_build_start", "state_built",
        #: "prefetch_start" and "prefetch_end" (the restore prefetch's
        #: staging, when it ran), "restore_done" (the checkpoint in
        #: the state), "restored" (snapshot buffers ready too),
        #: "first_step_done"
        self.marks = {}
        self._restart_coord = None
        #: the device_prefetch of the last passes over the data
        self.prefetches = collections.deque(maxlen=16)
        if args.checkpoint_dir:
            if args.snapshot_mode not in ("auto", "copy", "staged"):
                raise ValueError(
                    f"snapshot_mode {args.snapshot_mode!r}: auto, copy or "
                    "staged")
            from dlrover_tpu_torch.common import env
            from dlrover_tpu_torch.trainer.checkpoint.engine import (
                CheckpointEngine,
            )

            from dlrover_tpu_torch.trainer.drain import (
                install_drain_handler,
            )

            self._engine = CheckpointEngine(
                checkpoint_dir=args.checkpoint_dir,
                process_rank=env.get_process_rank(),
                process_count=env.get_process_count(),
                node_rank=env.get_node_index(),
                local_shard_num=env.get_local_process_count(),
            )
            # the restart critical path: start staging the restore's
            # bytes now, so that they stream while init_state builds the
            # state in _init_or_restore_state.  After a world change the
            # blind prefetch would stage the old world's shard, so the
            # restore is the serial, layout-aware load instead
            prev_world = env.prev_world_size()
            if not (prev_world > 0
                    and prev_world != self._ctx.world_size):
                from dlrover_tpu_torch.trainer.restart_path import (
                    RestartCoordinator,
                )

                self._restart_coord = RestartCoordinator(
                    self._engine).start()
            # graceful drain: the agent's SIGUSR1 switches to a blocking
            # snapshot at every step (_maybe_checkpoint)
            install_drain_handler()

    @property
    def checkpoint_engine(self):
        """The flash-checkpoint engine (None without ``checkpoint_dir``);
        its ``io_log`` holds the drains and the restore of this run."""
        return self._engine

    def _init_state(self) -> int:
        if self.state is None:
            self._init_or_restore_state()
        return self.state["step"]

    def restore(self) -> int:
        """Build the state and restore the newest checkpoint (what
        ``train()`` does first when it has not been done); returns the
        step training resumes from."""
        return self._init_state()

    def snapshot(self) -> bool:
        """Snapshot the current step to shared memory now, blocking until
        it is there (a drain still running finishes first).  A step
        already there is not written again: a second copy would take the
        other slot, whose older step may be the one the ranks share.
        Returns whether the step is in shared memory."""
        if self._engine is None:
            raise ValueError("snapshot() needs TrainingArgs.checkpoint_dir")
        self._init_state()
        self._engine.wait_for_snapshot(timeout=600)
        if self.state["step"] in self._engine._usable_shm_steps(
                self._layouts):
            return True
        return self._engine.save_to_memory(
            self.state["step"], self.state, blocking=True,
            layouts=self._layouts)

    # ------------------------------------------------------------ resume
    def _init_or_restore_state(self) -> int:
        """Initialise the state, then overwrite it with the newest
        checkpoint the engine agrees on (the bytes the prefetch staged
        meanwhile, or the serial ``engine.load``), and fault in the
        shared memory of the snapshots to come."""
        self.marks["state_build_start"] = time.time()
        self.state = self._fns.init_state(self._rng_seed)
        self.marks["state_built"] = time.time()
        if self._engine is None:
            return 0
        from dlrover_tpu_torch.trainer.checkpoint.reshard import (
            derive_layouts,
        )

        self._layouts = derive_layouts(self.state, self._fns.placements)
        coord, self._restart_coord = self._restart_coord, None
        if coord is not None:
            # the derived layouts supersede the blind prefetch's; one
            # restart, one prefetch: a later re-init reads fresh
            # availability through the serial load
            step, restored = coord.finish_restore(
                target=self.state, layouts=self._layouts)
            prefetch = coord.prefetch
            if prefetch is not None:
                prefetch.join(60)  # past its last leaf already
                if prefetch.finished_at is not None:
                    self.marks["prefetch_start"] = prefetch.started_at
                    self.marks["prefetch_end"] = prefetch.finished_at
        else:
            step, restored = self._engine.load(
                target=self.state, layouts=self._layouts)
        self.marks["restore_done"] = time.time()
        if step >= 0 and restored is not None:
            logger.info("resumed training from step %d", step)
        self.progress.global_step = self.state["step"]
        self._engine.preallocate_like(self.state)
        self._snapshot_mode = self._resolve_snapshot_mode()
        logger.info("snapshot mode: %s", self._snapshot_mode)
        if self._snapshot_mode == "copy":
            # before the first step, so that the steps' activations are
            # cached around them: made at a snapshot, they would take
            # the blocks the next step's activations were cached in
            self._snap = self._snapshot_buffers()
        self.marks["restored"] = time.time()
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
        from dlrover_tpu_torch.trainer.drain import drain_requested

        # drain mode (the agent's SIGUSR1: the node is about to go): a
        # blocking snapshot at every step, so that the agent's flush
        # persists the newest step and not the last periodic one
        draining = drain_requested()
        to_storage = step % self._args.save_storage_interval == 0
        to_memory = step % self._args.save_memory_interval == 0 or draining
        if not (to_storage or to_memory):
            return
        t0 = time.perf_counter()
        # "staged" hands over the live tensors and blocks until they are
        # in shm; "copy" hands over copies made on the compute stream
        # now, which no later step writes, and returns at once
        blocking = self._snapshot_mode == "staged" or draining
        saved = False
        if draining:
            # a "copy" drain still reading its buffers finishes first
            self._engine.wait_for_snapshot(timeout=600)
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
        self._callbacks.on_save(step, storage=to_storage)

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

    def _couple_ranks(self):
        """At world > 1, the ranks' host loops meet after every step.
        The gradient all-reduce couples the ranks' arithmetic, but it is
        queued on the card: the host goes on before it completes, and
        NCCL reports a dead peer only at its timeout.  Without the
        barrier a rank would snapshot a step that a dead peer never
        finished, and the ranks' snapshots would share no step for the
        restart (C4).  The barrier runs on the host (gloo), where a dead
        peer fails it at once; an NCCL barrier would synchronise the
        card's stream at every step."""
        if self._ctx.world_size > 1:
            import torch.distributed as dist

            dist.barrier(group=self._ctx.host_group)
            self.progress.restart_step_clock()

    def _prefetch(self, iterator):
        """The pass's batches on the card: the rank's rows, copied on a
        copy stream two batches ahead (inline fetch when the input
        pipeline is switched off)."""
        from dlrover_tpu_torch.common.env import input_pipeline_enabled
        from dlrover_tpu_torch.data.prefetch import device_prefetch

        it = device_prefetch(iterator, size=2,
                             sharding=self._fns.batch_sharding,
                             pipelined=input_pipeline_enabled())
        self.prefetches.append(it)
        return it

    def h2d_times(self):
        """``{"bytes", "host_ms", "copy_ms"}`` of the batches the
        passes so far handed out (the last 1,024 of each pass)."""
        return [t for it in self.prefetches for t in it.h2d_times()]

    def _mark_start(self):
        """Where the next step's time starts: now, on the card's clock
        (an event queued behind all earlier work) or the host's."""
        if self._fns.device.type == "cuda":
            self._last_done = torch.cuda.Event(enable_timing=True)
            self._last_done.record()
        else:
            self._last_done = time.perf_counter()

    def _consume_metrics(self, step: int, metrics, batch=None) -> float:
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
        self.marks.setdefault("first_step_done", time.time())
        if self._spikes is not None:
            self._spikes.observe(step, loss, batch)
        record = {"loss": loss, "step_time_s": dt}
        if "grad_norm" in metrics:
            record["grad_norm"] = float(metrics["grad_norm"])
        self._callbacks.on_step_end(step, record)
        self.history.append({"step": step, **record})
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
        batches = self._prefetch(it_fn())
        try:
            for batch in batches:
                if max_batches and count >= max_batches:
                    break
                metrics = self._fns.eval_step(self.state, batch)
                if pending is not None:
                    total += float(pending["loss"])
                pending = metrics
                count += 1
        finally:
            batches.close()
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
        self._callbacks.on_eval(self.state["step"], result)
        return result

    def train(self):
        from dlrover_tpu_torch.trainer.fault_tolerance import (
            HangDetector,
            default_hang_action,
        )

        step = self._init_state()
        hang = HangDetector(timeout=self._args.hang_timeout,
                            on_hang=default_hang_action)
        hang.start()
        self._callbacks.on_train_begin(step)
        step_times = []
        eval_every = (
            self._args.eval_interval if self._eval_iter_fn is not None
            else 0
        )
        pending = None  # (step, metrics, batch) read one step late
        # False from train_step until the ranks have met after it:
        # train_step updates the state in place, so an exception there
        # leaves a state no checkpoint may hold; and a step whose barrier
        # failed (a peer died before it) must not take the shm slot of a
        # step the peers share, or the restart finds no common step
        whole = True
        self._mark_start()
        try:
            while step < self._args.max_steps:
                batches = self._prefetch(self._data_iter_fn())
                try:
                    for batch in batches:
                        if step >= self._args.max_steps:
                            break
                        if self._replay is not None:
                            # the batch is on the card: the recorder
                            # copies it back (replay is an opt-in debug
                            # mode, correctness over overlap)
                            self._replay.record(step + 1, batch)
                        whole = False
                        self.state, metrics = self._fns.train_step(
                            self.state, batch)
                        step += 1
                        if (self._replay is not None
                                and self._args.replay_digest_interval > 0
                                and step % self._args.replay_digest_interval
                                == 0):
                            self._replay.commit(step, self.state)
                        self.progress.step_done()
                        hang.report_step(step)
                        self._couple_ranks()
                        whole = True
                        if pending is not None:
                            step_times.append(self._consume_metrics(*pending))
                        pending = (step, metrics, batch)
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
                finally:
                    batches.close()
            if pending is not None:
                step_times.append(self._consume_metrics(*pending))
        except BaseException:
            hang.stop()
            if self._engine is not None:
                try:
                    self._final_checkpoint(step if whole else None)
                except Exception:  # noqa: BLE001 - the first error wins
                    logger.exception("final checkpoint after a failure")
            raise
        hang.stop()
        if self._engine is not None:
            self._final_checkpoint(step)
        summary = {
            "final_step": step,
            "mean_step_time": (
                sum(step_times) / len(step_times) if step_times else 0.0
            ),
        }
        self._callbacks.on_train_end(summary)
        return summary
