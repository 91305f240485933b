"""Restart critical-path scheduler: overlap the recovery legs.

Port of ``dlrover_tpu/trainer/restart_path.py``.  Restart-to-first-step
latency is goodput lost to every failure, and the post-restart sequence
— process start → world join → state build → checkpoint restore →
first step — would run strictly serially although its expensive legs
use disjoint resources:

- **restore** moves bytes (shm/storage → host memory → card);
- **state build** (``init_state``: the params and optimizer state on
  the card) runs kernels and the caching allocator;
- **rendezvous** is pure coordination wait.

This module sequences them so the restore's staging runs beside the
others:

1. :meth:`RestartCoordinator.start` kicks the restore **byte prefetch**
   (``CheckpointEngine.start_prefetch``: what is restorable, the shm
   slot opened, or the leaf-streamed storage read, on a thread) the
   moment the worker knows its checkpoint dir;
2. :meth:`finish_restore` runs the cross-rank step consensus and copies
   the leaves to the card, a shm slot's straight from the segment's
   file, a storage stream's as they land
   (``CheckpointEngine.finish_restore``);
3. :meth:`resolve_train_step` hands the first step a compiled artifact
   when a compile leg delivered one.  The reference's compile leg
   (XLA's ahead-of-time compile) has no torch counterpart: the kernels'
   libraries are built once and loaded in milliseconds (``ops/_build.py``),
   so the ``Trainer`` starts the coordinator with no compile leg, as the
   reference's ``Trainer`` does.  ``compile_fn`` stays for API parity
   and runs whatever callable it is given on its own thread.

Degradation contract: ``DLROVER_TPU_RESTART_OVERLAP=0`` — or ANY leg
thread failing — reproduces the serial order with byte-identical
restored state.  The legs emit ``restart_path`` child spans
(``restore_prefetch`` / ``aot_compile`` / ``rendezvous_wait`` /
``finish_restore``) on the event timeline, so the goodput ledger shows
the measured overlap.
"""

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from dlrover_tpu_torch.common.env import (
    RESTART_OVERLAP_ENV as OVERLAP_ENV,
    restart_overlap_enabled,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.observability.events import (
    anchored_now,
    get_event_logger,
)


def overlap_enabled() -> bool:
    """``DLROVER_TPU_RESTART_OVERLAP`` ("0"/"false"/"off" forces the
    serial restart order)."""
    return restart_overlap_enabled()


def _gate_for(barrier: Optional[threading.Barrier]):
    """Start-alignment gate: both legs begin together so their spans
    measure real concurrency.  Best-effort — a broken/timed-out
    barrier must never block a leg."""
    if barrier is None:
        return None

    def gate():
        try:
            barrier.wait(timeout=5.0)
        except threading.BrokenBarrierError:
            pass

    return gate


class _CompileLeg:
    """The background compile thread (the span keeps the reference's
    ``aot_compile`` name).  Failure is recorded, never raised into the
    restart path — the first step falls back to the ``train_step`` it
    was built with."""

    def __init__(self, fn: Callable, gate=None, events=None):
        self._fn = fn
        self._gate = gate
        self._events = events or get_event_logger()
        self.result = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="restart-aot-compile", daemon=True
        )
        self._thread.start()

    def _run(self):
        if self._gate is not None:
            self._gate()
        t0_mono = time.monotonic()
        t0_wall = anchored_now(t0_mono)
        try:
            self.result = self._fn()
        except Exception as e:  # noqa: BLE001 - degrade, never corrupt
            self.error = e
            logger.warning(
                "background compile leg failed: %s (the first step "
                "uses the train step as built)", e,
            )
        finally:
            self._events.complete(
                "aot_compile",
                t0_wall,
                time.monotonic() - t0_mono,
                ok=self.error is None,
            )
            self._done.set()

    def wait(self, timeout: Optional[float] = None):
        self._done.wait(timeout)
        return self.result if self.error is None else None


class RestartCoordinator:
    """Sequences one restart's recovery legs; see the module doc.

    Typical worker bootstrap::

        engine = CheckpointEngine(...)
        coord = RestartCoordinator(engine).start()
        with coord.rendezvous_wait():
            init_distributed()          # the process group
        state = fns.init_state(seed)
        step, state = coord.finish_restore(target=state)

    ``start`` may run BEFORE the process group exists (the prefetch
    touches only shm and storage) — the byte stream then overlaps the
    rendezvous too.
    """

    def __init__(self, engine=None, events=None,
                 overlap: Optional[bool] = None):
        self._engine = engine
        self._events = events or get_event_logger()
        self.overlap = overlap_enabled() if overlap is None else overlap
        self._prefetch = None
        self._compile_leg: Optional[_CompileLeg] = None
        self._path_sid = -1
        self._pending = set()
        self._started = False

    # ------------------------------------------------------------ legs
    def start(self, compile_fn: Optional[Callable] = None,
              checkpoint_dir: Optional[str] = None,
              layouts=None) -> "RestartCoordinator":
        """Launch the overlappable legs.  Safe to call once; a second
        ``start`` only adds a compile leg if none ran yet (the worker
        may start the prefetch before the process group and a compile
        leg after it).

        ``layouts`` ({keypath: global-layout dict},
        ``trainer/checkpoint/reshard.py``) makes the restore byte
        prefetch reshard-aware: after a world change it streams
        whichever shard files cover this rank's NEW slices — the
        reshard-copy leg then rides the same overlap window as the
        state build and the rendezvous."""
        if not self.overlap:
            return self
        legs = []
        if self._engine is not None and self._prefetch is None:
            legs.append("prefetch")
        if compile_fn is not None and self._compile_leg is None:
            legs.append("compile")
        if not legs:
            return self
        if not self._started:
            self._started = True
            self._path_sid = self._events.begin("restart_path")
        barrier = (
            threading.Barrier(len(legs)) if len(legs) > 1 else None
        )
        try:
            if "prefetch" in legs:
                self._pending.add("restore")
                self._prefetch = self._engine.start_prefetch(
                    checkpoint_dir=checkpoint_dir,
                    start_gate=_gate_for(barrier),
                    layouts=layouts,
                )
            if "compile" in legs:
                self._pending.add("compile")
                self._compile_leg = _CompileLeg(
                    compile_fn, gate=_gate_for(barrier),
                    events=self._events,
                )
        except Exception as e:  # noqa: BLE001 - overlap is an optimization
            logger.warning(
                "restart overlap launch failed: %s (serial path)", e
            )
            self.overlap = False
        return self

    @contextmanager
    def rendezvous_wait(self):
        """Wrap the device-world wait (``init_process_group``) so the
        ledger sees the coordination leg of this restart."""
        with self._events.span("rendezvous_wait"):
            yield

    # --------------------------------------------------------- resolve
    def finish_restore(self, target=None,
                       checkpoint_dir: Optional[str] = None,
                       layouts=None):
        """Consensus + staged-bytes application; serial ``load`` when
        overlap is off, was never started, or any leg failed.  Returns
        ``(step, state)`` like ``CheckpointEngine.load``.  ``layouts``
        supersedes what ``start`` passed — a caller that only learns
        its target slices after the prefetch launched (the Trainer
        derives them from the initialized state) still gets the
        layout-aware reshard fallback."""
        try:
            if self._engine is None:
                return -1, None
            if not self.overlap or self._prefetch is None:
                return self._engine.load(
                    target=target, checkpoint_dir=checkpoint_dir,
                    layouts=layouts,
                )
            return self._engine.finish_restore(
                self._prefetch, target=target,
                checkpoint_dir=checkpoint_dir, layouts=layouts,
            )
        finally:
            self._resolved("restore")

    def resolve_train_step(self, fallback: Optional[Callable] = None,
                           timeout: float = 600.0):
        """What the compile leg returned when it delivered, else
        ``fallback`` (the train step as built).  Waits for an in-flight
        compile leg — the first step should block on its artifact, not
        build it a second time."""
        try:
            if self._compile_leg is None:
                return fallback
            compiled = self._compile_leg.wait(timeout)
            return compiled if compiled is not None else fallback
        finally:
            self._resolved("compile")

    def _resolved(self, leg: str):
        self._pending.discard(leg)
        if self._started and not self._pending:
            self._started = False
            self._events.end("restart_path", sid=self._path_sid)

    @property
    def prefetch(self):
        """The restore prefetch ``start`` launched (None when it did
        not: overlap off, no engine)."""
        return self._prefetch

    def close(self):
        """End the parent span early (abandoned restart path)."""
        self._pending.clear()
        if self._started:
            self._started = False
            self._events.end("restart_path", sid=self._path_sid)
